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
// bytes per row of traffic: operations, far above the card's ridge point.
// What kept the first (WMMA) version at 4% of the bf16 peak at C = 128 was
// the weight path: every warp loaded its B fragments straight from L2 inside
// the tap loop, with nothing in flight, and each fragment fed two products.
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
// f32 (dtype 0), `trio_kernel<FmaConv<C>>`: exact FP32 FMAs on the CUDA
// cores (tensor cores would round to TF32). Activations sit channel-major
// ([C][rows]) so a warp reads 32 consecutive rows without bank conflicts at
// any tap shift; each thread holds a 4-row x 16-channel register tile fed by
// warp-uniform weight reads from L2; the weights are (K, C_in, C_out).

#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxRes = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxConvs = 2 * kMaxRes * kMaxDil;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// Conv epilogue for one output element: round the f32 sum to T, add the
// bias in T, zero rows outside [0, M); FIRST stores lrelu(y) (conv2's
// input), otherwise y is added into the residual.
template <typename T, bool FIRST>
__device__ __forceinline__ void epilogue(T* p, float acc, float bias, bool in_seq) {
  float y = in_seq ? round_t<T>(round_t<T>(acc) + bias) : 0.f;
  *p = FIRST ? from_f<T>(lrelu<T>(y)) : from_f<T>(to_f(*p) + y);
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores, buffers channel-major [C][BR]
// ---------------------------------------------------------------------------
template <int C>
struct FmaConv {
  using T = float;
  static constexpr int kCN = 16;  // output channels per thread
  static constexpr int kRM = 4;   // rows per thread per pass

  __device__ static int buf_elems(int BR) { return C * BR; }
  __device__ static int at(int c, int l, int BR) { return c * BR + l; }
  static size_t smem_bytes(int tile, int halo) {
    return (size_t)2 * C * (tile + 2 * halo) * sizeof(float);
  }

  // dst rows [olo, ohi) <- conv(in) with taps at r - pad + k*d
  template <bool FIRST>
  __device__ static void conv(const float* __restrict__ in, float* __restrict__ dst,
                              const float* __restrict__ w, const float* __restrict__ bias,
                              int K, int d, int pad, int olo, int ohi, int BR, int row0,
                              int M) {
    constexpr int kNCG = C / kCN;               // channel groups: 1, 2, 4, 8
    constexpr int kNRG = kWarps / kNCG;         // warps sharing a channel group
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int o0 = (warp % kNCG) * kCN;
    const int rg = warp / kNCG;
    const int span = kNRG * 32 * kRM;
    for (int base = olo; base < ohi; base += span) {
      int src[kRM];
#pragma unroll
      for (int j = 0; j < kRM; ++j)
        src[j] = min(base + (rg * kRM + j) * 32 + lane, ohi - 1) - pad;
      float acc[kRM][kCN];
#pragma unroll
      for (int j = 0; j < kRM; ++j)
#pragma unroll
        for (int c = 0; c < kCN; ++c) acc[j][c] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* wk = w + (size_t)k * C * C + o0;
        const float* ink = in + k * d;
#pragma unroll 4
        for (int i = 0; i < C; ++i) {
          float a[kRM];
#pragma unroll
          for (int j = 0; j < kRM; ++j) {
            const float v = ink[i * BR + src[j]];
            a[j] = FIRST ? lrelu<float>(v) : v;
          }
          const float4* wp = reinterpret_cast<const float4*>(wk + (size_t)i * C);
          float wv[kCN];
#pragma unroll
          for (int q = 0; q < kCN / 4; ++q) {
            const float4 t = __ldg(wp + q);
            wv[4 * q] = t.x; wv[4 * q + 1] = t.y; wv[4 * q + 2] = t.z; wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int j = 0; j < kRM; ++j)
#pragma unroll
            for (int c = 0; c < kCN; ++c) acc[j][c] = fmaf(a[j], wv[c], acc[j][c]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRM; ++j) {
        const int r = base + (rg * kRM + j) * 32 + lane;
        if (r >= ohi) continue;
        const int g = row0 + r;
#pragma unroll
        for (int c = 0; c < kCN; ++c)
          epilogue<float, FIRST>(dst + (o0 + c) * BR + r, acc[j][c], bias[o0 + c],
                                 g >= 0 && g < M);
      }
    }
  }
};

template <class Conv, int C>
__global__ void __launch_bounds__(kThreads)
trio_kernel(const typename Conv::T* __restrict__ x, const typename Conv::T* __restrict__ w,
            const typename Conv::T* __restrict__ bias, typename Conv::T* __restrict__ out,
            int M, int tile, TrioGeom g) {
  using T = typename Conv::T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = g.halo;
  const int BR = tile + 2 * H;
  T* xb = reinterpret_cast<T*>(smem_raw);   // running residual of a resblock
  T* xt = xb + Conv::buf_elems(BR);         // activated conv1 output
  const int t0 = blockIdx.x * tile;
  const T* xg = x + (size_t)blockIdx.y * C * M;
  T* og = out + (size_t)blockIdx.y * C * M;
  const int row0 = t0 - H;

  size_t woff = 0;
  int conv = 0;
  for (int r = 0; r < g.n_res; ++r) {
    const int K = g.k[r];
    int hr = 0;
    for (int i = 0; i < g.n_dil; ++i) hr += g.pad1[r * kMaxDil + i] + g.pad2[r * kMaxDil + i];
    int lo = H - hr, hi = H + tile + hr;
    const int len = hi - lo;
    for (int e = threadIdx.x; e < C * len; e += kThreads) {
      const int c = e / len, l = lo + e % len;
      const int gr = row0 + l;
      xb[Conv::at(c, l, BR)] = (gr >= 0 && gr < M) ? xg[(size_t)c * M + gr] : from_f<T>(0.f);
    }
    __syncthreads();
    for (int i = 0; i < g.n_dil; ++i) {
      const int d = g.dil[r * kMaxDil + i];
      const int p1 = g.pad1[r * kMaxDil + i], p2 = g.pad2[r * kMaxDil + i];
      Conv::template conv<true>(xb, xt, w + woff, bias + conv * C, K, d, p1, lo + p1,
                                hi - p1, BR, row0, M);
      woff += (size_t)K * C * C;
      ++conv;
      __syncthreads();
      Conv::template conv<false>(xt, xb, w + woff, bias + conv * C, K, 1, p2, lo + p1 + p2,
                                 hi - p1 - p2, BR, row0, M);
      woff += (size_t)K * C * C;
      ++conv;
      __syncthreads();
      lo += p1 + p2;
      hi -= p1 + p2;
    }
    // rows [H, H + tile) now hold this resblock's output: fold it into the
    // output tile (each element is read and written by the same thread)
    for (int e = threadIdx.x; e < C * tile; e += kThreads) {
      const int c = e / tile, l = e % tile;
      const int gr = t0 + l;
      if (gr >= M) continue;
      const size_t gi = (size_t)c * M + gr;
      const float v = to_f(xb[Conv::at(c, H + l, BR)]);
      float s = r == 0 ? v : round_t<T>(to_f(og[gi]) + v);
      if (r == g.n_res - 1) s = s / (float)g.n_res;
      og[gi] = from_f<T>(s);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, weights streamed through shared memory
// ---------------------------------------------------------------------------
namespace mma_path {

constexpr int kThreadsM = 512;           // 16 warps, one block per SM
constexpr int kWarpsM = kThreadsM / 32;
constexpr int kStages = 3;               // weight ring slots
constexpr int kSlotBytes = 16384;        // one slot (the largest chunk)
constexpr int kSlotElems = kSlotBytes / 2;
constexpr int kSlack = 16;               // rows a last m16 tile may read past a region
constexpr int kBatch = 8;                // rows a lane loads at once in the copy loops

// Every conv of the trio in launch order: taps, dilation, padding, its output
// rows [olo, ohi) in buffer coordinates (block-independent), its rounds, and
// its first row in the weight stream (rows of C_out).
struct ConvTab {
  int n_res, n_dil, n_convs;
  int k[kMaxConvs], d[kMaxConvs], pad[kMaxConvs], olo[kMaxConvs], ohi[kMaxConvs];
  int rounds[kMaxConvs], wrow[kMaxConvs];
};

template <int C>
struct Cfg {
  static constexpr int kCPR = C / 8;                  // 16-byte chunks per row
  static constexpr int kWN = C >= 128 ? 2 : 1;        // warps across the outputs
  static constexpr int kWM = kWarpsM / kWN;           // warps across the rows
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

// The position of a chunk in the weight stream: conv j, round r, chunk c.
struct Cursor {
  int j, r, c;
};

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
    for (int e = threadIdx.x; e < rows * Cfg<C>::kCPR; e += kThreadsM) {
      const int r = e / Cfg<C>::kCPR, u = e % Cfg<C>::kCPR;
      mma::cp_async16(slot + swz<C>(r, 8 * u), src + (size_t)r * C + 8 * u, true);
    }
    if (++cu.c == n_chunks<C>(tb, cu.j)) {
      cu.c = 0;
      if (++cu.r == tb.rounds[cu.j]) {
        cu.r = 0;
        ++cu.j;
      }
    }
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
__global__ void __launch_bounds__(kThreadsM, 1)
trio_mma(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
         bf16* __restrict__ out, int M, int tile, int halo, const __grid_constant__ ConvTab tb) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int BR = tile + 2 * halo + kSlack;
  WeightRing ring{reinterpret_cast<bf16*>(smem_raw), {0, 0, 0}, 0};
  bf16* xb = ring.s + kStages * kSlotElems;    // running residual of a resblock
  bf16* xt = xb + BR * C;                      // activated conv1 output
  const int t0 = blockIdx.x * tile;
  const int row0 = t0 - halo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* xg = x + (size_t)blockIdx.y * C * M;
  bf16* og = out + (size_t)blockIdx.y * C * M;

  for (int s = 0; s < kStages - 1; ++s) issue<C>(ring.prod, ring.s + s * kSlotElems, w, tb);

  for (int r = 0; r < tb.n_res; ++r) {
    const int j0 = 2 * r * tb.n_dil;
    const int lo = tb.olo[j0] - tb.pad[j0], hi = tb.ohi[j0] + tb.pad[j0];
    // x rows [lo, hi) into xb: a warp reads 32 consecutive rows of one
    // channel per load, kBatch loads in flight before the stores
    for (int c = warp; c < C; c += kWarpsM) {
      const bf16* src = xg + (size_t)c * M;
      for (int l0 = lo + lane; l0 < hi; l0 += 32 * kBatch) {
        bf16 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int l = l0 + 32 * u, gr = row0 + l;
          v[u] = (l < hi && gr >= 0 && gr < M) ? src[gr] : from_f<bf16>(0.f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (l0 + 32 * u < hi) xb[swz<C>(l0 + 32 * u, c)] = v[u];
      }
    }
    // (the first chunk's barrier in conv() orders these stores before any read)
    for (int i = 0; i < tb.n_dil; ++i) {
      conv<C, true>(xb, xt, w, bias, tb, j0 + 2 * i, ring, row0, M);
      conv<C, false>(xt, xb, w, bias, tb, j0 + 2 * i + 1, ring, row0, M);
    }
    __syncthreads();
    // rows [H, H + tile) now hold this resblock's output: fold it into the
    // output tile (each element is read and written by the same thread)
    for (int c = warp; c < C; c += kWarpsM) {
      bf16* dst = og + (size_t)c * M;
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
          const float v = to_f(xb[swz<C>(halo + l, c)]);
          float s = r == 0 ? v : round_t<bf16>(prev[u] + v);
          if (r == tb.n_res - 1) s = s / (float)tb.n_res;
          dst[t0 + l] = from_f<bf16>(s);
        }
      }
    }
    __syncthreads();   // before the next resblock's load overwrites xb
  }
  mma::cp_async_wait<0>();
}

template <int C>
size_t smem_bytes(int tile, int halo) {
  return (size_t)kStages * kSlotBytes + (size_t)2 * (tile + 2 * halo + kSlack) * C * sizeof(bf16);
}

// The conv table of a tile: the same region bookkeeping as trio_kernel.
template <int C>
ConvTab conv_table(const TrioGeom& g, int tile) {
  ConvTab tb{};
  tb.n_res = g.n_res;
  tb.n_dil = g.n_dil;
  const int H = g.halo, per_round = Cfg<C>::kRoundTiles;
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

template <int C>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int M,
                   int tile, const TrioGeom& g, cudaStream_t stream) {
  if (!mma::aligned16({w})) return cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes<C>(tile, g.halo);
  auto kern = trio_mma<C>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + tile - 1) / tile, B);
  kern<<<grid, kThreadsM, smem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                          static_cast<const bf16*>(bias), static_cast<bf16*>(out),
                                          M, tile, g.halo, conv_table<C>(g, tile));
  return cudaGetLastError();
}

}  // namespace mma_path

template <int C>
cudaError_t launch_fma(const void* x, const void* w, const void* bias, void* out, int B, int M,
                       int tile, const TrioGeom& g, cudaStream_t stream) {
  using Conv = FmaConv<C>;
  const size_t smem = Conv::smem_bytes(tile, g.halo);
  auto kern = trio_kernel<Conv, C>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + tile - 1) / tile, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(w),
                                         static_cast<const float*>(bias),
                                         static_cast<float*>(out), M, tile, g);
  return cudaGetLastError();
}

cudaError_t dispatch_c(int dtype, const void* x, const void* w, const void* bias, void* out,
                       int B, int C, int M, int tile, const TrioGeom& g, cudaStream_t s) {
#define L2S_TRIO_CASE(CC)                                                     \
  case CC:                                                                     \
    return dtype == 0 ? launch_fma<CC>(x, w, bias, out, B, M, tile, g, s)     \
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

// x, out (B, C, M); w: every conv's (K, Cin, Cout) weights back to back, in
// x's dtype (bf16: 16-byte aligned); bias (n_convs, C). geom: [n_res, n_dil,
// halo, k[4], dil[4*4], pad1[4*4], pad2[4*4]] in host memory, read before
// the launch. dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core
// kernel). tile: output rows per block; the caller sizes it to the shared
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
