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
// both dtypes. What kept the first versions of both paths far from the peak
// (4% of bf16 for the WMMA version, ~9.5% of the f32 FMA peak for the FMA
// version) was the weight path: every warp read its weights straight from L2
// inside the tap loop, with nothing in flight. Both paths now stream the
// weights through a shared-memory ring and run on the tensor cores.
//
// bf16 (dtype 1), `trio_mma`: each conv is a GEMM, rows x C_out, reduced
// over taps x C_in, on mma.sync m16n8k16 (bf16 in, f32 accumulate; the
// mma_tile.cuh primitives). We chose mma.sync over wgmma: A comes from an
// activation buffer at a row offset that changes with every tap (k*d - pad,
// any dilation), which ldmatrix takes per lane as it is, while wgmma's
// shared-memory descriptors need 8-row-aligned core matrices.
//  * Weights through shared memory. The weights of all convs form one stream
//    of chunks of min(8192 / C, 128) rows of the (K * C_in, C_out) matrix
//    (16 KB at C >= 64; never across a conv), which runs through a ring of
//    kStages = 3 slots by 16-byte cp.async: the ring loads two chunks ahead
//    of the products, across conv and resblock boundaries, and every warp of
//    the block reads each chunk from shared memory, so a weight crosses from
//    L2 to the SM once per block and round (below) instead of once per warp
//    and slab. One barrier per chunk: every 8 k16 steps at C <= 64, 4 at 128.
//  * Warp tiles. 16 warps; at C = 128 two warps share a row band, each
//    owning 64 of the outputs, below that one warp owns all C. A warp
//    accumulates kMT = 128 / its outputs tiles of 16 rows (64 f32 registers
//    at every C: 32 x 64 at C = 128 and 64, 64 x 32 at 32, 128 x 16 at 16),
//    so a B fragment feeds kMT products and an A fragment its outputs / 8.
//    The m16 tiles of a conv's region go to the row warps in turn; a round
//    is the tiles they hold at once (256 rows at C = 128, 512 at 64, 1024
//    at 32, 2048 at 16), and a longer region takes more rounds, each
//    streaming the conv's weights again.
//  * Activations sit row-major ([rows][C] bf16) with the 16-byte chunks of a
//    row XOR-swizzled by the row (`swz`), so the eight rows of an ldmatrix,
//    at any tap shift, hit distinct banks; the tap shift is only a row offset
//    of the lanes' ldmatrix addresses. The weight chunk is [rows][C_out] in
//    the same swizzle, read with ldmatrix.trans. The tile's rows come in from
//    the (B, C, M) layout one channel per warp, 32 rows a load and eight
//    loads in flight a lane (a transpose; the output fold likewise).
//  * Epilogue straight from the accumulator fragments (no staging tile):
//    each lane owns two adjacent columns of two rows, rounds the f32 sum to
//    bf16, adds the bias (bf16, read through L1) and rounds again, zeroes
//    rows outside [0, M), and stores lrelu(y) (conv1) or round(xb + y)
//    (conv2) as one 4-byte word. The cross-resblock sum and the division by
//    n_res stay in the output tile, as in the f32 path.
//  * Budget and fill (per block: 512 threads at most 128 registers, one
//    block and 16 warps per SM; ptxas spills 8-56 bytes in the four
//    instantiations): shared memory = 48 KB of weight ring + two activation
//    buffers of (tile + 2H + 16) rows x C x 2 B, within the wrapper's 220
//    KB. At H = 60 the largest tile that fits is 208 rows at C = 128, 544 at
//    C = 64, 1232 at C = 32 and 2608 at C = 16. The wrapper (fused_tail.py:
//    tile_rows) counts a block's work as the chunk steps of its busiest
//    warp (rounds that fill few warps cost as much as full ones) and takes
//    the even tile with the least waves x that work: at batch 4 x 240
//    frames 194 / 388 / 1164 / 2328 rows (396 / 396 / 264 / 264 blocks on
//    132 SMs), at batch 1 x 96 frames 60 / 118 / 234 / 466 rows (128 / 131
//    / 132 / 132 blocks, where the largest tiles would leave 37 / 29 / 25 /
//    24): smaller tiles fill the card, larger ones recompute less halo.
//  * conv1's lrelu runs on the A fragments after ldmatrix, once per tap and
//    column warp: max(v, bf16(0.1 v)) in one f32 multiply a value, one pack
//    and one bf16x2 max (6 instructions a register, not 13), so that conv1's
//    issue slots go to the products.
//
// f32 (dtype 0), `trio_tf32`: the same GEMMs on mma.sync m16n8k8 in 3xTF32
// (f32 accumulate), the bf16 path's structure with f32 buffers.
//  * Accuracy. Each operand is split as hi = v rounded to TF32 (as
//    cvt.rna.tf32.f32 rounds) and lo = v - hi, and a product is lo_a hi_b +
//    hi_a lo_b + hi_a hi_b: what is dropped (lo_a lo_b, and lo's bits below
//    TF32, which the tensor core ignores) is ~2^-21 of |a b|, so the conv
//    agrees with an f32 conv to about summation order (2e-6 of max |ref|
//    against cuDNN's f32 convs on an H100). One TF32 product alone (~2^-11)
//    would not.
//  * The kernel is bound by issue, not by the tensor cores: a TF32 product
//    needs its operands split, and cvt.rna.tf32.f32 compiles to 4
//    instructions (a NaN guard). So the split is an integer add of half a
//    TF32 ulp and a mask (2 instructions, the same rounding) plus one f32
//    subtract, lo is left unrounded, and the weights are split once per
//    block instead of once per warp: each chunk of 2048 / C columns of a
//    conv's (C_out, K * C_in) weights is staged through registers (a
//    thread loads its 4 floats of the next chunk from L2 before the
//    products of the current one, and splits and stores them after) into
//    one of two ring slots, as hi and lo halves of [C_out][2048 / C + 4]
//    floats, so that ldmatrix (b16 8x8 = 8 rows x 4 floats: lane g, t gets
//    row g, float t, which is the TF32 B fragment) reads 8 rows at distinct
//    banks. One barrier a chunk: 2 k8 steps at C = 128, 16 at C = 16.
//  * Activations sit row-major [rows][C + 4] f32: ldmatrix.x4 at rows base +
//    shift + (lane & 15), floats ci + 4 (lane >> 4) gives the A fragment in
//    one instruction, and the padded stride (16 bytes past a multiple of
//    128) keeps the eight rows of each 8x8 on distinct banks at any tap
//    shift. The A fragment is split after the load (conv1's lrelu first:
//    max(v, 0.1 v) is the epilogue's lrelu). No slack rows: a last m16 tile
//    reads up to 15 rows past its region, into the next buffer or the ring
//    behind xt; those rows only feed outputs past the region, never stored.
//  * Warps and rounds as in bf16 (16 warps, 64 f32 accumulators a lane),
//    but a warp owns 32 outputs (16 at C = 16) and 4 m16 tiles a round (8
//    at C = 16): at C = 128 four warps share a row band, at 64 two. Small
//    row tiles leave few m16 tiles a conv (4-11 at C = 128), and narrow
//    warps keep all 16 warps busy on them and halve each warp's B
//    fragments, the shared-memory reads that every row warp repeats; with
//    64 outputs a warp at C >= 64, as in bf16, batch 1 x 96 took 3.07 ms
//    instead of 2.27 (one-off A/B on an H100). A warp holds its n8 tiles'
//    B fragments (hi, lo) and streams its A fragments; the three products
//    of a tile go out term by term over the n8 tiles, so that consecutive
//    mma.sync write different accumulators.
//  * Fill: buffers of (tile + 2H) rows x (C + 4) x 4 B each plus the 33-40
//    KB ring fit 227 KB up to tiles of 60 / 238 / 566 / 1120 rows at C =
//    128 / 64 / 32 / 16; the wrapper picks the tile by the bf16 rule
//    (fused_tail.py: tile_rows), so a batch-1 x 96-frame stage gets 128 /
//    131 / 132 / 132 blocks on 132 SMs (the FMA kernel it replaces: 80 /
//    48 / 42 / 60).

#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxRes = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxConvs = 2 * kMaxRes * kMaxDil;
constexpr float kSlope = 0.1f;

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

// ---------------------------------------------------------------------------
// Shared by both paths: the conv table and the weight stream's cursor
// ---------------------------------------------------------------------------

// Every conv of the trio in launch order: taps, dilation, padding, its output
// rows [olo, ohi) in buffer coordinates (block-independent), its rounds, and
// its first row in the weight stream (rows of C: conv j's weights start at
// element wrow[j] * C in both layouts).
struct ConvTab {
  int n_res, n_dil, n_convs;
  int k[kMaxConvs], d[kMaxConvs], pad[kMaxConvs], olo[kMaxConvs], ohi[kMaxConvs];
  int rounds[kMaxConvs], wrow[kMaxConvs];
};

// The position of a chunk in the weight stream: conv j, round r, chunk c.
struct Cursor {
  int j, r, c;
};

// Advance the cursor past a chunk of conv cu.j, which has n_chunks chunks.
__device__ __forceinline__ void advance(Cursor& cu, const ConvTab& tb, int n_chunks) {
  if (++cu.c == n_chunks) {
    cu.c = 0;
    if (++cu.r == tb.rounds[cu.j]) {
      cu.r = 0;
      ++cu.j;
    }
  }
}

// The conv table of a tile; per_round: the m16 tiles a block computes at once.
ConvTab conv_table(const TrioGeom& g, int tile, int C, int per_round) {
  ConvTab tb{};
  tb.n_res = g.n_res;
  tb.n_dil = g.n_dil;
  const int H = g.halo;
  int j = 0, wrow = 0;
  auto add = [&](int k, int d, int pad, int olo, int ohi) {
    tb.k[j] = k;
    tb.d[j] = d;
    tb.pad[j] = pad;
    tb.olo[j] = olo;
    tb.ohi[j] = ohi;
    tb.rounds[j] = ((ohi - olo + 15) / 16 + per_round - 1) / per_round;
    tb.wrow[j] = wrow;
    wrow += k * C;
    ++j;
  };
  for (int r = 0; r < g.n_res; ++r) {
    const int K = g.k[r];
    int hr = 0;
    for (int i = 0; i < g.n_dil; ++i) hr += g.pad1[r * kMaxDil + i] + g.pad2[r * kMaxDil + i];
    int lo = H - hr, hi = H + tile + hr;
    for (int i = 0; i < g.n_dil; ++i) {
      const int p1 = g.pad1[r * kMaxDil + i], p2 = g.pad2[r * kMaxDil + i];
      add(K, g.dil[r * kMaxDil + i], p1, lo + p1, hi - p1);
      add(K, 1, p2, lo + p1 + p2, hi - p1 - p2);
      lo += p1 + p2;
      hi -= p1 + p2;
    }
  }
  tb.n_convs = j;
  return tb;
}

// ---------------------------------------------------------------------------
// Shared by both paths: the block, the tile's load and fold, the launch
// ---------------------------------------------------------------------------
constexpr int kThreads = 512;            // 16 warps, one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                // rows a lane loads at once in the copy loops

// x rows [lo, hi) of a batch item (xg: (C, M)) into the activation buffer
// xb, element (row, channel) at Buf::at: a warp reads 32 consecutive rows of
// one channel per load, kBatch loads in flight before the stores; rows
// outside [0, M) are zero.
template <int C, typename Buf, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ xg, T* __restrict__ xb, int lo,
                                          int hi, int row0, int M) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += kWarps) {
    const T* src = xg + (size_t)c * M;
    for (int l0 = lo + lane; l0 < hi; l0 += 32 * kBatch) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int l = l0 + 32 * u, gr = row0 + l;
        v[u] = (l < hi && gr >= 0 && gr < M) ? src[gr] : from_f<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (l0 + 32 * u < hi) xb[Buf::at(l0 + 32 * u, c)] = v[u];
    }
  }
}

// Rows [halo, halo + tile) of xb hold resblock r's output: fold them into
// the output tile (og: (C, M), rows t0..), rounding the running sum to T
// and dividing by n_res after the last. Each element is read and written
// by the same thread.
template <int C, typename Buf, typename T>
__device__ __forceinline__ void fold_rows(const T* __restrict__ xb, T* __restrict__ og, int r,
                                          int n_res, int t0, int tile, int halo, int M) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += kWarps) {
    T* dst = og + (size_t)c * M;
    for (int l0 = lane; l0 < tile; l0 += 32 * kBatch) {
      float prev[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int l = l0 + 32 * u;
        prev[u] = (r > 0 && l < tile && t0 + l < M) ? to_f(dst[t0 + l]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int l = l0 + 32 * u;
        if (l >= tile || t0 + l >= M) continue;
        const float v = to_f(xb[Buf::at(halo + l, c)]);
        float s = r == 0 ? v : round_t<T>(prev[u] + v);
        if (r == n_res - 1) s = s / (float)n_res;
        dst[t0 + l] = from_f<T>(s);
      }
    }
  }
}

// Launch a path's kernel over (row tiles, batch items) with smem bytes of
// dynamic shared memory. w must be 16-byte aligned: both paths read it in
// 16-byte pieces.
template <typename T, typename Kernel>
cudaError_t launch_trio(Kernel kern, size_t smem, const void* x, const void* w, const void* bias,
                        void* out, int B, int M, int tile, int halo, const ConvTab& tb,
                        cudaStream_t stream) {
  if (!mma::aligned16({w})) return cudaErrorMisalignedAddress;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + tile - 1) / tile, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                         static_cast<const T*>(bias), static_cast<T*>(out), M,
                                         tile, halo, tb);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, weights streamed through shared memory
// ---------------------------------------------------------------------------
namespace mma_path {

constexpr int kStages = 3;               // weight ring slots
constexpr int kSlotBytes = 16384;        // one slot (the largest chunk)
constexpr int kSlotElems = kSlotBytes / 2;
constexpr int kSlack = 16;               // rows a last m16 tile may read past a region

template <int C>
struct Cfg {
  static constexpr int kCPR = C / 8;                  // 16-byte chunks per row
  static constexpr int kWN = C >= 128 ? 2 : 1;        // warps across the outputs
  static constexpr int kWM = kWarps / kWN;            // warps across the rows
  static constexpr int kCols = C / kWN;               // outputs of one warp
  static constexpr int kNT = kCols / 8;               // its n8 tiles
  static constexpr int kMT = 128 / kCols;             // its m16 tiles per round (64 f32 acc)
  static constexpr int kKR = 8192 / C < 128 ? 8192 / C : 128;   // weight rows per chunk
  static constexpr int kSteps = kKR / 16;             // k16 steps of a full chunk
  static constexpr int kRoundTiles = kWM * kMT;
};

// element offset of (row, col) in a swizzled [rows][C] bf16 buffer: chunk
// c of a row sits at c ^ f(row), f chosen so that any 8 consecutive rows at
// one chunk cover the 8 bank groups of a 128-byte line
template <int C>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int kCPR = C / 8;
  const int f = kCPR >= 8 ? (row & 7) : kCPR == 4 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return row * C + ((((col >> 3) ^ f)) << 3) + (col & 7);
}

template <int C>
struct Buf {
  static __device__ __forceinline__ int at(int row, int col) { return swz<C>(row, col); }
};

// lrelu on both bf16 halves of an A-fragment register, the same values as
// the epilogue's lrelu: max(v, bf16(0.1 v)) is v for v >= 0 and the rounded
// negative branch below 0 (rounding is monotone and v is a bf16 value), in
// one f32 multiply a half, one pack and one bf16x2 max
__device__ __forceinline__ uint32_t lrelu2(uint32_t r) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  const float2 f = __bfloat1622float2(v);
  const __nv_bfloat162 m = __hmax2(v, __floats2bfloat162_rn(kSlope * f.x, kSlope * f.y));
  return *reinterpret_cast<const uint32_t*>(&m);
}

template <int C>
__device__ __forceinline__ int n_chunks(const ConvTab& tb, int j) {
  return (tb.k[j] * C + Cfg<C>::kKR - 1) / Cfg<C>::kKR;
}

// Start the 16-byte copies of the cursor's chunk into `slot` (nothing past
// the last conv), commit them as one group, and advance the cursor.
template <int C>
__device__ __forceinline__ void issue(Cursor& cu, bf16* slot, const bf16* __restrict__ w,
                                      const ConvTab& tb) {
  if (cu.j < tb.n_convs) {
    const int r0 = cu.c * Cfg<C>::kKR;
    const int rows = min(Cfg<C>::kKR, tb.k[cu.j] * C - r0);
    const bf16* src = w + ((size_t)tb.wrow[cu.j] + r0) * C;
    for (int e = threadIdx.x; e < rows * Cfg<C>::kCPR; e += kThreads) {
      const int r = e / Cfg<C>::kCPR, u = e % Cfg<C>::kCPR;
      mma::cp_async16(slot + swz<C>(r, 8 * u), src + (size_t)r * C + 8 * u, true);
    }
    advance(cu, tb, n_chunks<C>(tb, cu.j));
  }
  mma::cp_async_commit();
}

// The weight ring's state, carried from conv to conv.
struct WeightRing {
  bf16* s;
  Cursor prod;     // the next chunk to load
  int slot;        // the slot of the next chunk to compute
};

// dst rows [olo, ohi) of conv j <- conv(in); FIRST: conv1 (lrelu on its
// input, lrelu(y) stored), else conv2 (y added into dst).
template <int C, bool FIRST>
__device__ __forceinline__ void conv(const bf16* __restrict__ in, bf16* __restrict__ dst,
                                     const bf16* __restrict__ w, const bf16* __restrict__ bias,
                                     const ConvTab& tb, int j, WeightRing& ring, int row0,
                                     int M) {
  using Q = Cfg<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / Q::kWN, n0 = (warp % Q::kWN) * Q::kCols;
  const int g = lane >> 2, q = lane & 3;
  const int K = tb.k[j], shift0 = -tb.pad[j], d = tb.d[j];
  const int olo = tb.olo[j], ohi = tb.ohi[j];
  const int nch = n_chunks<C>(tb, j);
  const bf16* bj = bias + j * C;
  for (int rd = 0; rd < tb.rounds[j]; ++rd) {
    const int base0 = olo + 16 * (rd * Q::kRoundTiles + wm);   // the warp's first m16 tile
    float acc[Q::kMT][Q::kNT][4];
#pragma unroll
    for (int mt = 0; mt < Q::kMT; ++mt)
#pragma unroll
      for (int n = 0; n < Q::kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

    for (int c = 0; c < nch; ++c) {
      mma::cp_async_wait<kStages - 2>();
      __syncthreads();   // chunk c has landed; every warp is done with the slot refilled next
      issue<C>(ring.prod, ring.s + ((ring.slot + kStages - 1) % kStages) * kSlotElems, w, tb);
      const bf16* wt = ring.s + ring.slot * kSlotElems;
      ring.slot = (ring.slot + 1) % kStages;
      const int n_steps = min(Q::kKR, K * C - c * Q::kKR) / 16;
#pragma unroll
      for (int s = 0; s < Q::kSteps; ++s) {
        if (s >= n_steps) break;   // the last chunk of a conv may be short
        const int kr = c * Q::kKR + 16 * s;
        const int tap = kr / C, ci = kr % C;
        const int shift = shift0 + tap * d;
        uint32_t b[Q::kCols / 16][4];
#pragma unroll
        for (int np = 0; np < Q::kCols / 16; ++np)
          mma::ldsm_x4_t(b[np], mma::smem_u32(wt + swz<C>(
                                    16 * s + (lane & 7) + (((lane >> 3) & 1) << 3),
                                    n0 + 16 * np + ((lane >> 4) << 3))));
#pragma unroll
        for (int mt = 0; mt < Q::kMT; ++mt) {
          const int base = base0 + 16 * Q::kWM * mt;
          if (base >= ohi) break;   // warp-uniform
          uint32_t a[4];
          mma::ldsm_x4(a, mma::smem_u32(in + swz<C>(base + shift + (lane & 15),
                                                    ci + ((lane >> 4) << 3))));
          if (FIRST) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = lrelu2(a[e]);
          }
#pragma unroll
          for (int np = 0; np < Q::kCols / 16; ++np) {
            mma::mma16816(acc[mt][2 * np], a, b[np][0], b[np][1]);
            mma::mma16816(acc[mt][2 * np + 1], a, b[np][2], b[np][3]);
          }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < Q::kMT; ++mt) {
      const int base = base0 + 16 * Q::kWM * mt;
      if (base >= ohi) break;
#pragma unroll
      for (int n = 0; n < Q::kNT; ++n) {
        const int col = n0 + 8 * n + 2 * q;
        const float2 bv = __bfloat1622float2(
            __ldg(reinterpret_cast<const __nv_bfloat162*>(bj + col)));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = base + g + 8 * h;
          if (row >= ohi) continue;
          const int gr = row0 + row;
          const bool in_seq = gr >= 0 && gr < M;
          const float y0 =
              in_seq ? round_t<bf16>(round_t<bf16>(acc[mt][n][2 * h]) + bv.x) : 0.f;
          const float y1 =
              in_seq ? round_t<bf16>(round_t<bf16>(acc[mt][n][2 * h + 1]) + bv.y) : 0.f;
          uint32_t* p = reinterpret_cast<uint32_t*>(dst + swz<C>(row, col));
          if (FIRST) {
            *p = mma::pack_bf16(lrelu<bf16>(y0), lrelu<bf16>(y1));
          } else {
            const float2 old = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
            *p = mma::pack_bf16(old.x + y0, old.y + y1);
          }
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
trio_mma(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
         bf16* __restrict__ out, int M, int tile, int halo, const __grid_constant__ ConvTab tb) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int BR = tile + 2 * halo + kSlack;
  WeightRing ring{reinterpret_cast<bf16*>(smem_raw), {0, 0, 0}, 0};
  bf16* xb = ring.s + kStages * kSlotElems;    // running residual of a resblock
  bf16* xt = xb + BR * C;                      // activated conv1 output
  const int t0 = blockIdx.x * tile;
  const int row0 = t0 - halo;
  const bf16* xg = x + (size_t)blockIdx.y * C * M;
  bf16* og = out + (size_t)blockIdx.y * C * M;

  for (int s = 0; s < kStages - 1; ++s) issue<C>(ring.prod, ring.s + s * kSlotElems, w, tb);

  for (int r = 0; r < tb.n_res; ++r) {
    const int j0 = 2 * r * tb.n_dil;
    load_rows<C, Buf<C>>(xg, xb, tb.olo[j0] - tb.pad[j0], tb.ohi[j0] + tb.pad[j0], row0, M);
    // (the first chunk's barrier in conv() orders these stores before any read)
    for (int i = 0; i < tb.n_dil; ++i) {
      conv<C, true>(xb, xt, w, bias, tb, j0 + 2 * i, ring, row0, M);
      conv<C, false>(xt, xb, w, bias, tb, j0 + 2 * i + 1, ring, row0, M);
    }
    __syncthreads();
    fold_rows<C, Buf<C>>(xb, og, r, tb.n_res, t0, tile, halo, M);
    __syncthreads();   // before the next resblock's load overwrites xb
  }
  mma::cp_async_wait<0>();
}

template <int C>
size_t smem_bytes(int tile, int halo) {
  return (size_t)kStages * kSlotBytes + (size_t)2 * (tile + 2 * halo + kSlack) * C * sizeof(bf16);
}

template <int C>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int M,
                   int tile, const TrioGeom& g, cudaStream_t stream) {
  return launch_trio<bf16>(trio_mma<C>, smem_bytes<C>(tile, g.halo), x, w, bias, out, B, M,
                           tile, g.halo, conv_table(g, tile, C, Cfg<C>::kRoundTiles), stream);
}

}  // namespace mma_path

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync on the tensor cores, weights streamed through shared memory
// ---------------------------------------------------------------------------
namespace tf32_path {

template <int C>
struct Cfg {
  static constexpr int kS = C + 4;                    // activation row stride (floats)
  static constexpr int kKC = 2048 / C;                // weight columns (k) per chunk
  static constexpr int kWS = kKC + 4;                 // chunk row stride (floats)
  static constexpr int kHalf = C * kWS;               // one part (hi or lo) of a slot
  static constexpr int kSlot = 2 * kHalf;             // a slot: hi, then lo
  static constexpr int kCols = C < 32 ? C : 32;       // outputs of one warp
  static constexpr int kWN = C / kCols;               // warps across the outputs
  static constexpr int kWM = kWarps / kWN;            // warps across the rows
  static constexpr int kNT = kCols / 8;               // its n8 tiles
  static constexpr int kMT = 128 / kCols;             // its m16 tiles per round (64 f32 acc)
  static constexpr int kSteps = kKC / 8;              // k8 steps of a full chunk
  static constexpr int kRoundTiles = kWM * kMT;
  static_assert(C * kKC == 4 * kThreads, "a thread stages 4 floats of a chunk");
  // a last m16 tile reads up to 15 rows past its input region: past xt
  // those rows must still lie in the block's shared memory (the ring)
  static_assert(2 * kSlot >= 15 * kS, "ring too small to absorb the overread");
};

template <int C>
struct Buf {
  static __device__ __forceinline__ int at(int row, int col) { return row * Cfg<C>::kS + col; }
};

using mma::mma1688;
using mma::split;

// Term t of the 3xTF32 product a b: 0 = lo_a hi_b, 1 = hi_a lo_b, 2 = hi_a
// hi_b (t is a constant once the loops are unrolled). A tile's three terms
// go in this order, the small ones first, each over all of a warp's tiles
// before the next, so that consecutive products go to other accumulators.
__device__ __forceinline__ void mma_term(int t, float c[4], const uint32_t ah[4],
                                         const uint32_t al[4], const uint32_t bh[2],
                                         const uint32_t bl[2]) {
  const uint32_t* b = t == 1 ? bl : bh;
  mma1688(c, t == 0 ? al : ah, b[0], b[1]);
}

// The A fragment (hi, lo) of the 16 rows at `row` (the lane's own row
// already added), floats ci.. of an activation buffer; conv1 applies lrelu.
template <int C, bool FIRST>
__device__ __forceinline__ void load_a(uint32_t ah[4], uint32_t al[4], const float* in, int row,
                                       int col) {
  uint32_t a[4];
  mma::ldsm_x4(a, mma::smem_u32(in + row * Cfg<C>::kS + col));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = __uint_as_float(a[e]);
    if (FIRST) v = fmaxf(v, kSlope * v);
    split(v, ah[e], al[e]);
  }
}

// The B fragments (hi, lo) of n8 tiles n and n + 1 from a slot, already
// split (one ldmatrix.x4 each; the lane's row and column offset in wt).
template <int C>
__device__ __forceinline__ void load_b2(uint32_t bh[2][2], uint32_t bl[2][2], const float* wt) {
  uint32_t h[4], l[4];
  mma::ldsm_x4(h, mma::smem_u32(wt));
  mma::ldsm_x4(l, mma::smem_u32(wt + Cfg<C>::kHalf));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bh[e >> 1][e & 1] = h[e];
    bl[e >> 1][e & 1] = l[e];
  }
}

template <int C>
__device__ __forceinline__ int n_chunks(const ConvTab& tb, int j) {
  return (tb.k[j] * C + Cfg<C>::kKC - 1) / Cfg<C>::kKC;
}

// The weight ring: two slots, each a chunk (columns k0.. of conv j's (C_out,
// K * C_in) weights) split into hi and lo once for the whole block. A chunk
// is staged through registers: each thread loads its 4 floats (row n,
// columns 4u..) of the next chunk from L2 before the products of the
// current one, and splits and stores them after, into the other slot.
struct WeightRing {
  float* s;
  Cursor prod;     // the next chunk to load
  int slot;        // the slot of the chunk to compute
  float4 v;        // this thread's share of the next chunk
};

// Load the thread's share of the cursor's chunk (zeros past the conv's
// columns; nothing past the last conv) and advance the cursor.
template <int C>
__device__ __forceinline__ void fetch(WeightRing& ring, const float* __restrict__ w,
                                      const ConvTab& tb) {
  using Q = Cfg<C>;
  Cursor& cu = ring.prod;
  ring.v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cu.j >= tb.n_convs) return;
  const int kc = tb.k[cu.j] * C, k0 = cu.c * Q::kKC;
  const int n = threadIdx.x / (Q::kKC / 4), u = threadIdx.x % (Q::kKC / 4);
  if (4 * u < kc - k0)
    ring.v = __ldg(reinterpret_cast<const float4*>(w + (size_t)tb.wrow[cu.j] * C +
                                                   (size_t)n * kc + k0 + 4 * u));
  advance(cu, tb, n_chunks<C>(tb, cu.j));
}

// Split the fetched share and store it into `slot` (hi, then lo).
template <int C>
__device__ __forceinline__ void put(const WeightRing& ring, float* slot) {
  using Q = Cfg<C>;
  const int n = threadIdx.x / (Q::kKC / 4), u = threadIdx.x % (Q::kKC / 4);
  uint4 hi, lo;
  split(ring.v.x, hi.x, lo.x);
  split(ring.v.y, hi.y, lo.y);
  split(ring.v.z, hi.z, lo.z);
  split(ring.v.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(slot + n * Q::kWS + 4 * u) = hi;
  *reinterpret_cast<uint4*>(slot + Q::kHalf + n * Q::kWS + 4 * u) = lo;
}

// dst rows [olo, ohi) of conv j <- conv(in); FIRST: conv1 (lrelu on its
// input, lrelu(y) stored), else conv2 (y added into dst).
template <int C, bool FIRST>
__device__ __forceinline__ void conv(const float* __restrict__ in, float* __restrict__ dst,
                                     const float* __restrict__ w, const float* __restrict__ bias,
                                     const ConvTab& tb, int j, WeightRing& ring, int row0,
                                     int M) {
  using Q = Cfg<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / Q::kWN, n0 = (warp % Q::kWN) * Q::kCols;
  const int g = lane >> 2, q = lane & 3;
  const int K = tb.k[j], shift0 = -tb.pad[j], d = tb.d[j];
  const int olo = tb.olo[j], ohi = tb.ohi[j];
  const int nch = n_chunks<C>(tb, j);
  const float* bj = bias + j * C;
  // the lane's ldmatrix row and float offsets: A (rows, k) and B ([n][k])
  const int a_row = lane & 15, a_col = (lane >> 4) << 2;
  const int b_off = (n0 + (lane & 7) + ((lane >> 4) << 3)) * Q::kWS + (((lane >> 3) & 1) << 2);
  for (int rd = 0; rd < tb.rounds[j]; ++rd) {
    const int base0 = olo + 16 * (rd * Q::kRoundTiles + wm);   // the warp's first m16 tile
    // its m16 tiles this round (warp-uniform): tile mt starts at base0 + 16 kWM mt
    const int nmt = min(Q::kMT, max(0, (ohi - base0 + 16 * Q::kWM - 1) / (16 * Q::kWM)));
    float acc[Q::kMT][Q::kNT][4];
#pragma unroll
    for (int mt = 0; mt < Q::kMT; ++mt)
#pragma unroll
      for (int n = 0; n < Q::kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

    for (int c = 0; c < nch; ++c) {
      __syncthreads();   // chunk c is in ring.slot; every warp is done with the other slot
      fetch<C>(ring, w, tb);
      const float* wt = ring.s + ring.slot * Q::kSlot + b_off;
      const int n_steps = nmt == 0 ? 0 : min(Q::kKC, K * C - c * Q::kKC) / 8;
#pragma unroll
      for (int s = 0; s < Q::kSteps; ++s) {
        if (s >= n_steps) break;   // the last chunk of a conv may be short
        const int kr = c * Q::kKC + 8 * s;
        const int tap = kr / C, ci = kr % C;
        const int row = base0 + shift0 + tap * d + a_row;
        uint32_t bh[Q::kNT][2], bl[Q::kNT][2];
#pragma unroll
        for (int np = 0; np < Q::kNT / 2; ++np)
          load_b2<C>(bh + 2 * np, bl + 2 * np, wt + 16 * np * Q::kWS + 8 * s);
#pragma unroll
        for (int mt = 0; mt < Q::kMT; ++mt) {
          if (mt >= nmt) break;
          uint32_t ah[4], al[4];
          load_a<C, FIRST>(ah, al, in, row + 16 * Q::kWM * mt, ci + a_col);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
#pragma unroll
            for (int n = 0; n < Q::kNT; ++n) mma_term(t, acc[mt][n], ah, al, bh[n], bl[n]);
          }
        }
      }
      put<C>(ring, ring.s + (ring.slot ^ 1) * Q::kSlot);
      ring.slot ^= 1;
    }

#pragma unroll
    for (int mt = 0; mt < Q::kMT; ++mt) {
      if (mt >= nmt) break;
      const int base = base0 + 16 * Q::kWM * mt;
#pragma unroll
      for (int n = 0; n < Q::kNT; ++n) {
        const int col = n0 + 8 * n + 2 * q;
        const float2 bv = __ldg(reinterpret_cast<const float2*>(bj + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = base + g + 8 * h;
          if (row >= ohi) continue;
          const int gr = row0 + row;
          const bool in_seq = gr >= 0 && gr < M;
          const float y0 = in_seq ? acc[mt][n][2 * h] + bv.x : 0.f;
          const float y1 = in_seq ? acc[mt][n][2 * h + 1] + bv.y : 0.f;
          float2* p = reinterpret_cast<float2*>(dst + row * Q::kS + col);
          if (FIRST) {
            *p = make_float2(lrelu<float>(y0), lrelu<float>(y1));
          } else {
            const float2 old = *p;
            *p = make_float2(old.x + y0, old.y + y1);
          }
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
trio_tf32(const float* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ bias, float* __restrict__ out, int M, int tile, int halo,
          const __grid_constant__ ConvTab tb) {
  using Q = Cfg<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int BR = tile + 2 * halo;
  float* xb = reinterpret_cast<float*>(smem_raw);   // running residual of a resblock
  float* xt = xb + BR * Q::kS;                      // activated conv1 output
  WeightRing ring{xt + BR * Q::kS, {0, 0, 0}, 0, {}};   // behind xt: absorbs the overread
  const int t0 = blockIdx.x * tile;
  const int row0 = t0 - halo;
  const float* xg = x + (size_t)blockIdx.y * C * M;
  float* og = out + (size_t)blockIdx.y * C * M;

  fetch<C>(ring, w, tb);
  put<C>(ring, ring.s);

  for (int r = 0; r < tb.n_res; ++r) {
    const int j0 = 2 * r * tb.n_dil;
    load_rows<C, Buf<C>>(xg, xb, tb.olo[j0] - tb.pad[j0], tb.ohi[j0] + tb.pad[j0], row0, M);
    // (the first chunk's barrier in conv() orders these stores before any read)
    for (int i = 0; i < tb.n_dil; ++i) {
      conv<C, true>(xb, xt, w, bias, tb, j0 + 2 * i, ring, row0, M);
      conv<C, false>(xt, xb, w, bias, tb, j0 + 2 * i + 1, ring, row0, M);
    }
    __syncthreads();
    fold_rows<C, Buf<C>>(xb, og, r, tb.n_res, t0, tile, halo, M);
    __syncthreads();   // before the next resblock's load overwrites xb
  }
}

template <int C>
size_t smem_bytes(int tile, int halo) {
  return ((size_t)2 * (tile + 2 * halo) * Cfg<C>::kS + (size_t)2 * Cfg<C>::kSlot) * sizeof(float);
}

template <int C>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int M,
                   int tile, const TrioGeom& g, cudaStream_t stream) {
  return launch_trio<float>(trio_tf32<C>, smem_bytes<C>(tile, g.halo), x, w, bias, out, B, M,
                            tile, g.halo, conv_table(g, tile, C, Cfg<C>::kRoundTiles), stream);
}

}  // namespace tf32_path

cudaError_t dispatch_c(int dtype, const void* x, const void* w, const void* bias, void* out,
                       int B, int C, int M, int tile, const TrioGeom& g, cudaStream_t s) {
#define L2S_TRIO_CASE(CC)                                                     \
  case CC:                                                                     \
    return dtype == 0 ? tf32_path::launch<CC>(x, w, bias, out, B, M, tile, g, s) \
                      : mma_path::launch<CC>(x, w, bias, out, B, M, tile, g, s);
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

// x, out (B, C, M); w: every conv's weights back to back in x's dtype,
// 16-byte aligned: f32 (Cout, K, Cin), bf16 (K, Cin, Cout); bias (n_convs,
// C). geom: [n_res, n_dil, halo, k[4], dil[4*4], pad1[4*4], pad2[4*4]] in
// host memory, read before the launch. dtype: 0 = float32 (3xTF32 kernel),
// 1 = bfloat16 (bf16 kernel); both on the tensor cores. tile: output rows per block; the caller sizes it to the shared
// memory (fused_tail.py: tile_rows). Returns cudaGetLastError() after the
// launch.
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
