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
//
// One key-major pass for both input types, `rel_bias_bwd_mma<T>`
// (mma_tile.cuh). A block owns 64 keys of one (batch, head): K, V and the
// key mask stay in shared memory, dK and dV in registers. It loops over
// query tiles of 64, their Q_u and dO arriving by 16-byte cp.async. Per
// tile each warp takes its 16 query rows against its keys: S = Q_u K^T *
// scale + bias (f32, the bias streamed one tile ahead straight into the
// accumulator layout, as in the forward), dPr = dO V^T, P from the LSE, dS =
// P o (dPr o keep - D). dbias is that f32 dS, written from the fragments
// (float2, a 32-byte sector per quad) before dS is scaled or rounded; every
// (i, j) is written by exactly one block and tile, so dbias needs no zeroing
// and nothing past T is written. P~ and dS go to tiles; after a barrier the
// warps of keys 16w .. add dV += P~^T dO and dK += dS^T Q_u
// (`key_products`). dQ_u = dS K goes to an f32 buffer by four-float
// reductions (`red_add_rows`).
//   So the bias is read once and dbias written once, the byte floor, and
// five products run where the two-pass split of rel_attention_bwd.cu would
// run seven (S and dPr recomputed by both passes) and read the bias twice
// (12 T^2 bytes). The cost: dQ_u's f32 sums arrive in an order that changes
// from run to run, so its last bits may differ between runs (in bf16 then
// rounded); dK, dV and dbias are deterministic.
//   bf16 (dtype 1): mma.sync m16n8k16; 4 warps, each 16 query rows against
// the 64 keys, then keys 16w ..; Q_u and dO double-buffered; dQ_u from dS's
// registers, one reduction per lane and n-tile a tile; P~ and dS as
// swizzled bf16 [query][key] tiles read by ldmatrix .trans. 64.3 KB of
// shared memory and at most 255 registers: two blocks per SM, 32 KB of bias
// in flight.
//   f32 (dtype 0): every product in 3xTF32 on mma.sync m16n8k8 (as in the
// forward; held to 1e-4 of max(1, |ref|) a gradient and to DBIAS_TOL, which
// one TF32 product fails). 8 warps, two to each 16 query rows, each taking
// half the keys (S, dPr, dS, P~: 16 accumulators each a lane) and then half
// the channels of dK, dV and dQ_u; P~ and dS stored transposed, [key][query]
// at a row stride of 72, and read as A by float2 in the k8 order, with dO's
// and Q_u's rows read to match (rel_attention_bwd.cu's key pass); dQ_u =
// dS K reads dS back out of its transposed tile (keys 2q, 2q + 1 of a k8
// step, K's rows by single floats). Q_u and dO single-buffered: issued
// after a tile's last barrier, so each tile waits on device memory, and a
// second block on the SM hides it. 104.3 KB of shared memory and at most
// 128 registers (a 16-28 byte spill): two blocks of 8 warps per SM. One
// block with 255 registers took 1.84 ms at B8 H8 T1200 against 1.42 (NVIDIA
// H100 80GB HBM3, 700 W).
//   Alignment as in the forward: float2 accesses of bias and dbias for even
// T, single floats for odd T, chosen by the launcher (float2 is 15% faster
// in bf16 at B8 H8 T1200 and B4 H8 T480 on an H100); Q_u, K, V, dO, dK, dV
// and the dQ_u buffer must be 16-byte aligned, bias and dbias 4-byte.

#include "flash_bwd_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma;

// bf16: 4 warps, each owning 16 query rows of a tile against the block's
// 64 keys, and then 16 keys; Q_u and dO double-buffered. f32: 8 warps, two
// to each 16 rows, each taking half the keys (kw = 0 or 32) and then half
// the channels (32 cc ..); Q_u and dO single-buffered, so that two blocks
// fit an SM.
template <typename T>
struct Bwd {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kWarps = kBf16 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NT = kBf16 ? 8 : 4;         // n8 tiles of keys (and channels) a warp
  static constexpr int kStages = kBf16 ? 2 : 1;    // of Q_u and dO
  static constexpr int kMinBlocks = 2;
  static constexpr int E = Tile<T>::kElems;
  static constexpr int kPdElems = kBf16 ? kTile : kD * kPtLd;
  // K, V, the stages of Q_u and of dO, the P~ and dS tiles, the key-mask flags
  static constexpr size_t kSmem = ((size_t)(2 + 2 * kStages) * E + 2 * (size_t)kPdElems) * sizeof(T) +
                                  (size_t)kB * sizeof(float);
};

template <typename T>
struct Args {
  const T *qu, *k, *v, *d_o;
  const float* bias;
  const uint8_t* mask;
  const float *lse, *delta;
  float* dqu;                    // f32, zeroed: the reductions' target
  T *dk, *dv;
  float* dbias;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

// f32: dQ_u (rows 16w.., channels 32 cc ..) += dS K over the block's 64
// keys, dS read from its transposed tile (the keys of a k8 step in the
// order 0, 2, 4, 6, 1, 3, 5, 7, K's rows read to match).
__device__ __forceinline__ void dqu_from_ds(float dq[4][4], const float* sdS, const float* sK,
                                            int w, int cc, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    const float* d0 = sdS + (8 * ks + 2 * q) * kPtLd + 16 * w + g;   // key 2q, query g
    const uint32_t av[4] = {__float_as_uint(d0[0]), __float_as_uint(d0[8]),
                            __float_as_uint(d0[kPtLd]), __float_as_uint(d0[kPtLd + 8])};
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    split4(av, ah, al);
    load_b_cols<4>(bh, bl, sK + (8 * ks + 2 * q) * kLd32 + 32 * cc + g);
    mma3_tiles<4>(dq, ah, al, bh, bl);
  }
}

template <typename T, bool kVec2>
__global__ void __launch_bounds__(Bwd<T>::kThreads, Bwd<T>::kMinBlocks)
rel_bias_bwd_mma(const Args<T> g) {
  using P = Bwd<T>;
  constexpr int E = P::E, NT = P::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + E;
  T* sQu = sV + E;                  // kStages stages
  T* sdO = sQu + P::kStages * E;    // kStages stages
  T* sPd = sdO + P::kStages * E;    // P~ of the pair
  T* sdS = sPd + P::kPdElems;       // dS of the pair
  float* sM = reinterpret_cast<float*>(sdS + P::kPdElems);

  const int T_len = g.T_len, bh = blockIdx.y, j0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* bias_bh = g.bias + (size_t)bh * T_len * T_len;
  float* dbias_bh = g.dbias + (size_t)bh * T_len * T_len;
  const float* lse_bh = g.lse + (size_t)bh * T_len;
  const float* delta_bh = g.delta + (size_t)bh * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  // rows (keys) 16w..; keys kw..; bf16: constants of the warp, so that no offset is computed
  const int w = P::kBf16 ? warp : warp & 3, cc = P::kBf16 ? 0 : warp >> 2, kw = 8 * NT * cc;
  const int row_w = 16 * w + (lane >> 2);         // the lane's first row within a tile
  const int n_tiles = (T_len + kB - 1) / kB;

  load_tile<P::kThreads>(sK, g.k + base, j0, T_len);
  load_tile<P::kThreads>(sV, g.v + base, j0, T_len);
  flash::load_mask(sM, g.mask + (size_t)(bh / g.H) * T_len, j0, T_len);
  load_tile<P::kThreads>(sQu, g.qu + base, 0, T_len);
  load_tile<P::kThreads>(sdO, g.d_o + base, 0, T_len);
  cp_async_commit();
  float bt[NT][4];                // the bias of the lane's pair elements, a tile ahead
  load_frag_f32<kVec2, NT>(bt, bias_bh, T_len, row_w, j0 + kw, T_len, T_len, q);

  float dk[NT][4], dv[NT][4];
  zero<NT>(dk);
  zero<NT>(dv);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = P::kStages == 2 ? t & 1 : 0, i_g = t * kB + row_w;
    cp_async_wait<0>();
    __syncthreads();              // tile t has landed; tile t-1's tiles are consumed
    if constexpr (P::kStages == 2) {
      if (t + 1 < n_tiles) {      // stage st^1 was last read in tile t-1
        load_tile<P::kThreads>(sQu + (st ^ 1) * E, g.qu + base, (t + 1) * kB, T_len);
        load_tile<P::kThreads>(sdO + (st ^ 1) * E, g.d_o + base, (t + 1) * kB, T_len);
        cp_async_commit();
      }
    }
    const T* qt = sQu + st * E;
    const T* dot = sdO + st * E;
    float lse[2], delta[2];       // rows past the sequence: P = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i_g + 8 * r;
      lse[r] = i < T_len ? lse_bh[i] : -INFINITY;
      delta[r] = i < T_len ? delta_bh[i] : 0.f;
    }

    float s[NT][4], dpr[NT][4];
    zero<NT>(s);
    zero<NT>(dpr);
    {
      PassRowsA<T> a;
      a.init(dot, 16 * w, lane);
      product_nt<NT>(dpr, a, sV + Tile<T>::at(kw, 0), lane);
      a.init(qt, 16 * w, lane);
      product_nt<NT>(s, a, sK + Tile<T>::at(kw, 0), lane);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fmaf(s[n][e], g.scale, bt[n][e]);
    if (t + 1 < n_tiles)          // lands during the rest of this tile
      load_frag_f32<kVec2, NT>(bt, bias_bh, T_len, i_g + kB, j0 + kw, T_len, T_len, q);

    // P, P~ (to its tile) and dS = P o (dPr o keep - D), unscaled, in s
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float kf[4] = {1.f, 1.f, 1.f, 1.f};
      if (g.drop.thresh != 0u)
        keep_frag(g.drop, (uint32_t)bh, i_g, j0 + kw + 8 * n + 2 * q, q, kf);
      float pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = lse[r] > 0.5f * flash::kMasked && sM[kw + 8 * n + 2 * q + (e & 1)] > 0.f;
        const float prob = ok ? expf(s[n][e] - lse[r]) : 0.f;
        pd[e] = prob * kf[e];
        s[n][e] = prob * (dpr[n][e] * kf[e] - delta[r]);
      }
      store_pair_tile(sPd, pd, w, kw, n, lane);
    }
    store_frag_f32<kVec2, NT>(dbias_bh, s, T_len, i_g, j0 + kw, T_len, T_len, q);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= g.scale;
      store_pair_tile(sdS, s[n], w, kw, n, lane);
    }
    if constexpr (P::kBf16) {     // dQ_u of the warp's rows += dS K, to device memory
      float dq[8][4];
      zero(dq);
      product_acc_nn(dq, s, sK, lane);
      red_add_rows(dq, g.dqu + base, t * kB + 16 * w, T_len, lane);
    }
    __syncthreads();              // P~ and dS are complete
    key_products(dv, dk, sPd, sdS, dot, qt, w, cc, lane);
    if constexpr (!P::kBf16) {    // dQ_u (rows 16w.., channels 32 cc ..) += dS K
      float dq[4][4];
      zero<4>(dq);
      dqu_from_ds(dq, sdS, sK, w, cc, lane);
      red_add_rows<4>(dq, g.dqu + base + 32 * cc, t * kB + 16 * w, T_len, lane);
    }
    if constexpr (P::kStages == 1) {
      if (t + 1 < n_tiles) {
        __syncthreads();          // Q_u, dO, P~ and dS are consumed
        load_tile<P::kThreads>(sQu, g.qu + base, (t + 1) * kB, T_len);
        load_tile<P::kThreads>(sdO, g.d_o + base, (t + 1) * kB, T_len);
        cp_async_commit();
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  const int j_g = j0 + row_w;
  store_rows<NT>(g.dk + base + 8 * NT * cc, dk, j_g, T_len, one, q);
  store_rows<NT>(g.dv + base + 8 * NT * cc, dv, j_g, T_len, one, q);
}

template <typename T, bool kVec2>
cudaError_t launch_as(const Args<T>& g, int B, int H, cudaStream_t stream) {
  auto kern = rel_bias_bwd_mma<T, kVec2>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Bwd<T>::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.T_len + kB - 1) / kB, B * H);
  kern<<<grid, Bwd<T>::kThreads, Bwd<T>::kSmem, stream>>>(g);
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
  Args<T> g;
  g.qu = static_cast<const T*>(qu);
  g.k = static_cast<const T*>(k);
  g.v = static_cast<const T*>(v);
  g.d_o = static_cast<const T*>(d_o);
  g.bias = bias;
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = dqu;
  g.dk = static_cast<T*>(dk);
  g.dv = static_cast<T*>(dv);
  g.dbias = dbias;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  if (T_len % 2 == 0 && addr(bias) % 8 == 0 && addr(dbias) % 8 == 0)
    return launch_as<T, true>(g, B, H, stream);
  return launch_as<T, false>(g, B, H, stream);
}

}  // namespace

// All tensors contiguous. q_u, k, v, out, d_out and the gradients dk, dv:
// (B, H, T, dk) of the input type; bias and dbias (B, H, T, T) float32
// (dbias need not be zeroed); mask (B, T) uint8; lse (B, H, T) float32 from
// the forward; delta: float32 (B, H, T) scratch. dq_u: a float32 (B, H, T,
// dk) buffer, zeroed by the caller, that receives dq_u by reductions (for
// bf16 the caller rounds it). dtype: 0 = float32 (3xTF32), 1 = bfloat16.
// q_u, k, v, d_out, dk, dv and dq_u 16-byte aligned, bias and dbias 4-byte.
// Only dk = 64. rate and seed as given to the forward. Returns
// cudaGetLastError() after the launches.
extern "C" int l2s_rel_attention_bias_bwd(const void* qu, const void* k, const void* v,
                                          const void* bias, const void* mask, const void* lse,
                                          const void* out, const void* d_out, void* dqu,
                                          void* dk_out, void* dv_out, void* dbias, void* delta,
                                          int B, int H, int T_len, int dk, int dtype,
                                          float rate, unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const float* bi = static_cast<const float*>(bias);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* db = static_cast<float*>(dbias);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  cudaError_t e;
  float* dq = static_cast<float*>(dqu);
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
