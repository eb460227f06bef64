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
// bytes, so operations at long T; at the serving shapes (B4 H16 T240: 256
// blocks of 4 key tiles each) the card is not full and the time is one
// block's latency: its loads, its four tile steps and the launch.
//
// Design. The TPU kernel holds a head's whole K and V in VMEM and pads T to
// a block multiple; here one block owns a run of query rows of one (batch,
// head) and loops over key tiles of 64 with an online softmax, so shared
// memory does not grow with T (the unit extractor calls it at T = 5000) and
// nothing quadratic reaches device memory. Bounds are checked, so T needs no
// padded copy. The key mask is read as the (B, T) bytes it is, shared by the
// heads of a batch row; a null mask means every key is valid.
//
// One kernel for both input types, `attention_mma<T>`: rel_attention.cu's
// tensor-core loop without the position term (mma_tile.cuh); the type picks
// the tiles, the products and the epilogue's stores. 4 warps x 16 query
// rows; the Q fragments stay in registers; K and V tiles arrive by 16-byte
// cp.async, double-buffered, so tile j+1 loads while tile j computes; the
// mask and the online softmax run on the accumulator fragments, and P is the
// A operand of P V straight from its accumulator.
//
// bf16 (dtype 1): S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32
// accumulate) from swizzled tiles; P is rounded to bf16 in registers. 41.5
// KB of shared memory and at most 128 registers: four blocks (16 warps) per
// SM.
//
// f32 (dtype 0): the same loop in 3xTF32 on mma.sync m16n8k8 (each operand
// split into a TF32 hi, rounded as cvt.rna rounds, and an f32 lo = v - hi;
// lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 accumulation, about 2^-21 of
// |a b| dropped), so the path is held to 3e-5 against the plain version,
// which one TF32 product (~1e-4 to 1e-3 off) does not meet. f32 tiles of 64
// x 68 floats. Q is staged through the second V stage and held unsplit in
// registers (split at each use); K and V are split after they are read. P
// stays in registers as the A of P V: a k8 step takes its keys in the order
// 0, 2, 4, 6, 1, 3, 5, 7, which is where the m16n8 accumulator holds them,
// and V's rows are read in that order by single floats (conflict-free at
// the stride of 68). 68.5 KB of shared memory: three blocks per SM.
//
// Small grids. Where blocks of 64 query rows would leave SMs idle (the
// flagship's f32 request B1 H16 T96: 32 blocks; unit extraction's B1 H12
// T500: 96, on 132 SMs), the f32 launch takes 32 rows a block (kSplit 2):
// two warps share each 16 rows, each takes 32 keys of every tile with its
// own online softmax, and the pair combine their (max, sum, output) through
// shared memory at the end, so the grid doubles and each warp's serial
// path halves. On full grids that costs 4-21% (K and V read by twice the
// blocks, the combine), so they keep 64 rows a block. (NVIDIA H100 80GB
// HBM3, 700 W: 0.0124 -> 0.0095 ms at T96, 0.0301 -> 0.0277 at T500;
// 0.0304 -> 0.0369 at B4 H16 T240, 1.501 -> 1.568 at B1 H12 T4999.)

#include "mma_tile.cuh"

namespace {

using namespace mma;

// kSplit: warps that share 16 query rows, each on its share of a tile's keys
template <typename T, int kSplit>
struct Fwd {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static_assert(kSplit == 1 || (!kBf16 && kSplit == 2), "bf16: 64 rows a block");
  static constexpr int kRows = kB / kSplit;        // query rows a block
  static constexpr int kNT = 8 / kSplit;           // n8 key tiles a warp
  static constexpr int kMinBlocks = kBf16 ? 4 : 3;
  // bf16: a Q tile of its own; f32: Q staged through the second V stage
  static constexpr int kQTiles = kBf16 ? 1 : 0;
  // the Q tile, two stages of K and of V, two stages of mask flags
  static constexpr size_t kSmem =
      (size_t)(kQTiles + 4) * Tile<T>::kElems * sizeof(T) + (size_t)2 * kB * sizeof(float);
  // a warp's partial result in the combine: 16 x 64 output, max and sum of 16 rows
  static constexpr int kPart = 16 * kLd32 + 32;
};

template <typename T, int kSplit>
__global__ void __launch_bounds__(kThreads, Fwd<T, kSplit>::kMinBlocks)
attention_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int T_len,
              float scale) {
  using F = Fwd<T, kSplit>;
  constexpr int E = Tile<T>::kElems, kNT = F::kNT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw) + F::kQTiles * E;   // two stages
  T* sV = sK + 2 * E;                                         // two stages
  float* sM = reinterpret_cast<float*>(sV + 2 * E);           // two stages
  T* sQ = F::kBf16 ? reinterpret_cast<T*>(smem_raw) : sV + E;

  const int bh = blockIdx.y, i0 = blockIdx.x * F::kRows;
  const size_t base = (size_t)bh * T_len * kD;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / H) * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rg = warp % (kWarps / kSplit);           // the warp's group of 16 rows
  const int share = warp / (kWarps / kSplit);        // its share of each tile's keys
  const int kw = 8 * kNT * share;                    // the share's first key in a tile
  const int i_g = i0 + 16 * rg + (lane >> 2);        // the lane's first row
  const int n_tiles = (T_len + kB - 1) / kB;

  if constexpr (F::kBf16)
    load_tile(sQ, q + base, i0, T_len);
  else
    load_tile<kThreads, F::kRows>(sQ, q + base, i0, T_len);
  load_tile(sK, k + base, 0, T_len);
  load_tile(sV, v + base, 0, T_len);
  flash::load_mask(sM, mask_row, 0, T_len);
  cp_async_commit();

  RowsA<T> aq;
  if constexpr (!F::kBf16) {   // Q into registers before the second V stage is written
    cp_async_wait<0>();
    __syncthreads();
    aq.init(sQ, 16 * rg, lane);
    __syncthreads();
  }
  float o[8][4];
  zero(o);
  // a warp's share of a tile may lie past the sequence (scores -inf): its
  // running maximum starts at the masked score so that it stays finite
  const float m_init = kSplit == 1 ? -INFINITY : flash::kMasked;
  float m_run[2] = {m_init, m_init}, l_run[2] = {0.f, 0.f};

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
    const T* kt = sK + st * E + Tile<T>::at(kw, 0);
    const T* vt = sV + st * E + Tile<T>::at(kw, 0);
    const float* mt = sM + st * kB + kw;

    float s[kNT][4];
    zero<kNT>(s);
    product_nt<kNT>(s, aq, kt, lane);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = flash::mask_score(s[n][e] * scale, mt[8 * n + 2 * q4 + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: key j0 lies in the sequence, or the maximum starts finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m_run[e >> 1]);
        rs[e >> 1] += s[n][e];
        o[n][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int n = kNT; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    // the lane's share of the row sums; the quad adds them up at the end
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
    if constexpr (F::kBf16)
      product_acc_nn(o, s, vt, lane);
    else
      product_acc_nn<kNT>(o, s, vt, lane);
    __syncthreads();   // stage st is consumed
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kSplit == 2) {
    // the second share's partial through the (consumed) K stages; the first
    // rescales both to the common maximum and adds them up
    float* x = reinterpret_cast<float*>(sK) + rg * F::kPart;
    const int g = lane >> 2;
    if (share == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(x + (g + 8 * h) * kLd32 + 8 * n + 2 * q4) =
              make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (q4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[16 * kLd32 + g + 8 * h] = m_run[h];
          x[16 * kLd32 + 16 + g + 8 * h] = l[h];
        }
      }
    }
    __syncthreads();
    if (share == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = x[16 * kLd32 + g + 8 * h], l1 = x[16 * kLd32 + 16 + g + 8 * h];
      const float m_new = fmaxf(m_run[h], m1);
      const float a = __expf(m_run[h] - m_new), b = __expf(m1 - m_new);
      l[h] = l[h] * a + l1 * b;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(x + (g + 8 * h) * kLd32 + 8 * n + 2 * q4);
        o[n][2 * h] = o[n][2 * h] * a + y.x * b;
        o[n][2 * h + 1] = o[n][2 * h + 1] * a + y.y * b;
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-20f);
  store_rows(out + base, o, i_g, T_len, inv, q4);
}

template <typename T, int kSplit>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                   int B, int H, int T_len, cudaStream_t stream) {
  using F = Fwd<T, kSplit>;
  if (!aligned16({q, k, v, out})) return cudaErrorMisalignedAddress;
  auto kern = attention_mma<T, kSplit>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)F::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + F::kRows - 1) / F::kRows, B * H);
  kern<<<grid, kThreads, F::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), H, T_len, 1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q, k, v, out (B, H, T, dk); mask (B, T) uint8 or
// null (every key valid). dtype: 0 = float32 (3xTF32), 1 = bfloat16;
// pointers 16-byte aligned. Only dk = 64. Returns cudaGetLastError() after
// the launch.
extern "C" int l2s_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int T_len, int dk, int dtype,
                             void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1) return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    int dev, n_sm;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    const long blocks = (long)(T_len + kB - 1) / kB * B * H;   // at 64 rows a block
    e = blocks < n_sm ? launch<float, 2>(q, k, v, m, out, B, H, T_len, s)
                      : launch<float, 1>(q, k, v, m, out, B, H, T_len, s);
  } else if (dtype == 1) {
    e = launch<bf16, 1>(q, k, v, m, out, B, H, T_len, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
