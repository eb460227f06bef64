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
// bytes, as long as the bias is read once.
//
// Design. The TPU kernel is one sequential program per (batch, head) that
// carries dK and dV across query blocks and wants bias and dbias re-tiled to
// (key block, row, 128 lanes). Here bias and dbias stay (T, T) rows, and a
// row-dot pre-pass (flash_bwd_tile.cuh) writes D from the forward's output.
//
// bf16 (dtype 1), `rel_bias_bwd_mma`: one key-major pass, every product on
// mma.sync m16n8k16 with f32 accumulation (mma_tile.cuh). A block owns 64
// keys of one (batch, head): K, V and the key mask stay in shared memory, dK
// and dV in registers. It loops over query tiles of 64, their Q_u and dO
// double-buffered by 16-byte cp.async. Per tile, warp w takes its 16 query
// rows against the 64 keys: S = Q_u K^T * scale + bias (f32, the bias
// streamed one tile ahead straight into the accumulator layout, as in the
// forward), dPr = dO V^T, P from the LSE, dS = P o (dPr o keep - D). dbias is
// that f32 dS, written from the fragments (float2, a 32-byte sector per
// quad) before dS is scaled and rounded to bf16; every (i, j) is written by
// exactly one block and tile, so dbias needs no zeroing and nothing past T
// is written. dQ_u = dS K comes from dS's registers and goes to an f32
// buffer by four-float reductions (`red_add_rows`), one per lane and n-tile
// per tile pair. P~ and dS go to bf16 tiles; after a barrier warp w adds
// dV += P~^T dO and dK += dS^T Q_u for keys 16w .. (ldmatrix .trans).
//   So the bias is read once and dbias written once, the byte floor. The
// cost: dQ_u's f32 sums arrive in an order that changes from run to run, so
// its last bits may differ between runs (then rounded to bf16); dK, dV and
// dbias are deterministic. The alternative, the query pass / key pass split
// of rel_attention_bwd.cu, is deterministic but reads the bias twice
// (12 T^2 bytes). 64.3 KB of shared memory and at most 255 registers: two
// blocks per SM, with 32 KB of bias in flight.
//   Alignment as in the forward: float2 accesses of bias and dbias for even
// T, single floats for odd T, chosen by the launcher (float2 is 15% faster at
// B8 H8 T1200 and B4 H8 T480 on an H100); Q_u, K, V, dO and the dQ_u buffer
// must be 16-byte aligned, bias and dbias 4-byte.
//
// f32 (dtype 0), `bias_bwd_{query,key}_pass`: the first version,
// unchanged on the CUDA cores: two passes in parallel blocks (FP32 FMAs,
// f32 shared tiles, flash_bwd_tile.cuh; the query pass writes dbias and dQ_u
// once, so everything is deterministic), because the f32 path is held to
// 1e-4 against the CPU and TF32 cannot meet that.

#include "flash_bwd_tile.cuh"
#include "mma_tile.cuh"

namespace {

namespace mma_path {

using namespace mma;

// K, V, two stages of Q_u and of dO, the P~ and dS tiles, the key-mask flags
constexpr size_t kSmem = (size_t)8 * kTile * sizeof(bf16) + (size_t)kB * sizeof(float);

struct Args {
  const bf16 *qu, *k, *v, *d_o;
  const float* bias;
  const uint8_t* mask;
  const float *lse, *delta;
  float* dqu;                    // f32, zeroed: the reductions' target
  bf16 *dk, *dv;
  float* dbias;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

template <bool kVec2>
__global__ void __launch_bounds__(kThreads, 2) rel_bias_bwd_mma(const Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile;
  bf16* sQu = sV + kTile;         // two stages
  bf16* sdO = sQu + 2 * kTile;    // two stages
  bf16* sPd = sdO + 2 * kTile;    // P~ of the pair, [query][key]
  bf16* sdS = sPd + kTile;        // dS of the pair, [query][key]
  float* sM = reinterpret_cast<float*>(sdS + kTile);

  const int T_len = g.T_len, bh = blockIdx.y, j0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* bias_bh = g.bias + (size_t)bh * T_len * T_len;
  float* dbias_bh = g.dbias + (size_t)bh * T_len * T_len;
  const float* lse_bh = g.lse + (size_t)bh * T_len;
  const float* delta_bh = g.delta + (size_t)bh * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int row_w = 16 * warp + (lane >> 2);      // the lane's first row within a tile
  const int n_tiles = (T_len + kB - 1) / kB;

  load_tile(sK, g.k + base, j0, T_len);
  load_tile(sV, g.v + base, j0, T_len);
  flash::load_mask(sM, g.mask + (size_t)(bh / g.H) * T_len, j0, T_len);
  load_tile(sQu, g.qu + base, 0, T_len);
  load_tile(sdO, g.d_o + base, 0, T_len);
  cp_async_commit();
  float bt[8][4];                 // the bias of the lane's pair elements, a tile ahead
  load_frag_f32<kVec2>(bt, bias_bh, T_len, row_w, j0, T_len, T_len, q);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, i_g = t * kB + row_w;
    cp_async_wait<0>();
    __syncthreads();              // tile t has landed; tile t-1's tiles are consumed
    if (t + 1 < n_tiles) {        // stage st^1 was last read in tile t-1
      load_tile(sQu + (st ^ 1) * kTile, g.qu + base, (t + 1) * kB, T_len);
      load_tile(sdO + (st ^ 1) * kTile, g.d_o + base, (t + 1) * kB, T_len);
      cp_async_commit();
    }
    const bf16* qt = sQu + st * kTile;
    const bf16* dot = sdO + st * kTile;
    float lse[2], delta[2];       // rows past the sequence: P = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i_g + 8 * r;
      lse[r] = i < T_len ? lse_bh[i] : -INFINITY;
      delta[r] = i < T_len ? delta_bh[i] : 0.f;
    }

    float s[8][4], dpr[8][4];
    zero(s);
    zero(dpr);
    {
      uint32_t a[4][4];
      load_a(a, dot, 16 * warp, lane);
      product_nt(dpr, a, sV, lane);
      load_a(a, qt, 16 * warp, lane);
      product_nt(s, a, sK, lane);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fmaf(s[n][e], g.scale, bt[n][e]);
    if (t + 1 < n_tiles)          // lands during the rest of this tile
      load_frag_f32<kVec2>(bt, bias_bh, T_len, i_g + kB, j0, T_len, T_len, q);

    // P, P~ (to its bf16 tile) and dS = P o (dPr o keep - D), unscaled, in s
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float kf[4] = {1.f, 1.f, 1.f, 1.f};
      if (g.drop.thresh != 0u) keep_frag(g.drop, (uint32_t)bh, i_g, j0 + 8 * n + 2 * q, q, kf);
      float pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = lse[r] > 0.5f * flash::kMasked && sM[8 * n + 2 * q + (e & 1)] > 0.f;
        const float prob = ok ? expf(s[n][e] - lse[r]) : 0.f;
        pd[e] = prob * kf[e];
        s[n][e] = prob * (dpr[n][e] * kf[e] - delta[r]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(sPd + swz(row_w + 8 * h, 8 * n + 2 * q)) =
            pack_bf16(pd[2 * h], pd[2 * h + 1]);
    }
    store_frag_f32<kVec2>(dbias_bh, s, T_len, i_g, j0, T_len, T_len, q);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= g.scale;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(sdS + swz(row_w + 8 * h, 8 * n + 2 * q)) =
            pack_bf16(s[n][2 * h], s[n][2 * h + 1]);
    }
    {                             // dQ_u of the warp's rows += dS K, to device memory
      float dq[8][4];
      zero(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        to_a(a, s, kk);
        product_nn_step(dq, a, sK, kk, lane);
      }
      red_add_rows(dq, g.dqu + base, t * kB + 16 * warp, T_len, lane);
    }
    __syncthreads();              // P~ and dS are complete
    // warp w: keys 16w ..; dV += P~^T dO, dK += dS^T Q_u over the 64 query rows
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      ldsm_x4_t(a, tile_addr(sPd, a_cols(lane, 16 * warp, 16 * ks)));
      product_nn_step(dv, a, dot, ks, lane);
      ldsm_x4_t(a, tile_addr(sdS, a_cols(lane, 16 * warp, 16 * ks)));
      product_nn_step(dk, a, qt, ks, lane);
    }
  }
  const float one[2] = {1.f, 1.f};
  const int j_g = j0 + row_w;
  store_rows(g.dk + base, dk, j_g, T_len, one, q);
  store_rows(g.dv + base, dv, j_g, T_len, one, q);
}

template <bool kVec2>
cudaError_t launch_as(const Args& g, int B, int H, cudaStream_t stream) {
  auto kern = rel_bias_bwd_mma<kVec2>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kSmem, stream>>>(g);
  return cudaGetLastError();
}

cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   float* dqu, void* dk, void* dv, float* dbias, float* delta, int B, int H,
                   int T_len, philox::Dropout drop, cudaStream_t stream) {
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if (!aligned16({qu, k, v, d_o, dqu}) || addr(bias) % 4 != 0 || addr(dbias) % 4 != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t e = flash::launch_row_dot<bf16>(out, d_o, delta, (size_t)B * H * T_len, stream);
  if (e != cudaSuccess) return e;
  Args g;
  g.qu = static_cast<const bf16*>(qu);
  g.k = static_cast<const bf16*>(k);
  g.v = static_cast<const bf16*>(v);
  g.d_o = static_cast<const bf16*>(d_o);
  g.bias = bias;
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = dqu;
  g.dk = static_cast<bf16*>(dk);
  g.dv = static_cast<bf16*>(dv);
  g.dbias = dbias;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  if (T_len % 2 == 0 && addr(bias) % 8 == 0 && addr(dbias) % 8 == 0)
    return launch_as<true>(g, B, H, stream);
  return launch_as<false>(g, B, H, stream);
}

}  // namespace mma_path

namespace fma_path {

using namespace flash;

// query pass: Q_u, dO, K, V, dS tiles and the mask flags
constexpr size_t kQPassSmem = ((size_t)5 * kB * kS + kB) * sizeof(float);
// key pass: K, V, Q_u, dO, dS, P~ tiles and the mask flags
constexpr size_t kKPassSmem = ((size_t)6 * kB * kS + kB) * sizeof(float);

struct Args {
  const float *qu, *k, *v, *d_o;
  const float* bias;
  const uint8_t* mask;
  const float *lse, *delta;
  float *dqu, *dk, *dv;
  float* dbias;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

// The pair's scaled scores plus the thread's 4x4 bias tile.
__device__ __forceinline__ void bias_scores(const float* sQ, const float* sK,
                                            const float* __restrict__ bias_bh, int i0, int j0,
                                            int T_len, int ty, int tx, float scale,
                                            float s[4][4]) {
  float bt[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + 4 * tx + j;
      bt[a][j] = (i < T_len && jj < T_len) ? bias_bh[(size_t)i * T_len + jj] : 0.f;
    }
  }
  qk_product(sQ, sK, ty, tx, s);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = fmaf(s[a][j], scale, bt[a][j]);
}

__global__ void __launch_bounds__(kThreads) bias_bwd_query_pass(const Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + kB * kS;
  float* sK = sdO + kB * kS;
  float* sV = sK + kB * kS;
  float* sS = sV + kB * kS;      // scaled dS of the pair
  float* sM = sS + kB * kS;

  const int T_len = g.T_len;
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* bias_bh = g.bias + (size_t)bh * T_len * T_len;
  float* dbias_bh = g.dbias + (size_t)bh * T_len * T_len;
  const uint8_t* mask_row = g.mask + (size_t)(bh / g.H) * T_len;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sQ, g.qu + base, i0, T_len);
  load_tile(sdO, g.d_o + base, i0, T_len);
  float lse[4], delta[4];
  load_row_stats(g.lse + (size_t)bh * T_len, g.delta + (size_t)bh * T_len, i0, T_len, ty, lse,
                 delta);
  float dqu[4][4];
  zero_tile(dqu);

  for (int j0 = 0; j0 < T_len; j0 += kB) {
    __syncthreads();  // the previous pair's dS and keys are consumed
    load_tile(sK, g.k + base, j0, T_len);
    load_tile(sV, g.v + base, j0, T_len);
    load_mask(sM, mask_row, j0, T_len);
    __syncthreads();

    float s[4][4], dpr[4][4], keep[4][4], ds[4][4], pd[4][4];
    bias_scores(sQ, sK, bias_bh, i0, j0, T_len, ty, tx, g.scale, s);
    qk_product(sdO, sV, ty, tx, dpr);
    keep_tile(g.drop, bh, i0, j0, ty, tx, keep);
    backward_tile(s, sM, tx, lse, delta, keep, dpr, ds, pd);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + 4 * ty + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = j0 + 4 * tx + j;
        if (i < T_len && jj < T_len) dbias_bh[(size_t)i * T_len + jj] = ds[a][j];
        ds[a][j] *= g.scale;
      }
    }
    store_tile(sS, ty, tx, ds);
    __syncthreads();
    rows_product(sS, sK, ty, tx, dqu);
  }
  write_grad(g.dqu + base, i0, T_len, ty, tx, dqu);
}

__global__ void __launch_bounds__(kThreads) bias_bwd_key_pass(const Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kB * kS;
  float* sQ = sV + kB * kS;
  float* sdO = sQ + kB * kS;
  float* sS = sdO + kB * kS;     // scaled dS of the pair
  float* sPd = sS + kB * kS;     // dropped probabilities of the pair
  float* sM = sPd + kB * kS;

  const int T_len = g.T_len;
  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* bias_bh = g.bias + (size_t)bh * T_len * T_len;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sK, g.k + base, j0, T_len);
  load_tile(sV, g.v + base, j0, T_len);
  load_mask(sM, g.mask + (size_t)(bh / g.H) * T_len, j0, T_len);
  float dk[4][4], dv[4][4];
  zero_tile(dk);
  zero_tile(dv);

  for (int i0 = 0; i0 < T_len; i0 += kB) {
    __syncthreads();  // the previous pair's tiles are consumed
    load_tile(sQ, g.qu + base, i0, T_len);
    load_tile(sdO, g.d_o + base, i0, T_len);
    float lse[4], delta[4];
    load_row_stats(g.lse + (size_t)bh * T_len, g.delta + (size_t)bh * T_len, i0, T_len, ty,
                   lse, delta);
    __syncthreads();

    float s[4][4], dpr[4][4], keep[4][4], ds[4][4], pd[4][4];
    bias_scores(sQ, sK, bias_bh, i0, j0, T_len, ty, tx, g.scale, s);
    qk_product(sdO, sV, ty, tx, dpr);
    keep_tile(g.drop, bh, i0, j0, ty, tx, keep);
    backward_tile(s, sM, tx, lse, delta, keep, dpr, ds, pd);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[a][j] *= g.scale;
    store_tile(sS, ty, tx, ds);
    store_tile(sPd, ty, tx, pd);
    __syncthreads();
    cols_product(sS, sQ, ty, tx, dk);
    cols_product(sPd, sdO, ty, tx, dv);
  }
  write_grad(g.dk + base, j0, T_len, ty, tx, dk);
  write_grad(g.dv + base, j0, T_len, ty, tx, dv);
}

cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   void* dqu, void* dk, void* dv, float* dbias, float* delta, int B, int H,
                   int T_len, philox::Dropout drop, cudaStream_t stream) {
  cudaError_t e = launch_row_dot<float>(out, d_o, delta, (size_t)B * H * T_len, stream);
  if (e != cudaSuccess) return e;
  Args g;
  g.qu = static_cast<const float*>(qu);
  g.k = static_cast<const float*>(k);
  g.v = static_cast<const float*>(v);
  g.d_o = static_cast<const float*>(d_o);
  g.bias = bias;
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = static_cast<float*>(dqu);
  g.dk = static_cast<float*>(dk);
  g.dv = static_cast<float*>(dv);
  g.dbias = dbias;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  auto q_pass = bias_bwd_query_pass;
  e = cudaFuncSetAttribute(q_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kQPassSmem);
  if (e != cudaSuccess) return e;
  q_pass<<<grid, kThreads, kQPassSmem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto k_pass = bias_bwd_key_pass;
  e = cudaFuncSetAttribute(k_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kKPassSmem);
  if (e != cudaSuccess) return e;
  k_pass<<<grid, kThreads, kKPassSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace fma_path

}  // namespace

// All tensors contiguous. q_u, k, v, out, d_out and the gradients dk, dv:
// (B, H, T, dk) of the input type; bias and dbias (B, H, T, T) float32
// (dbias need not be zeroed); mask (B, T) uint8; lse (B, H, T) float32 from
// the forward; delta: float32 (B, H, T) scratch. dq_u: (B, H, T, dk) of the
// input type for dtype 0 (FMA kernels); for dtype 1 (tensor-core kernel) a
// float32 buffer, zeroed by the caller, that receives dq_u by reductions
// (the caller rounds it); q_u, k, v, d_out and that buffer 16-byte aligned,
// bias and dbias 4-byte. Only dk = 64. rate and seed as given to the
// forward. Returns cudaGetLastError() after the launches.
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
  if (dtype == 0)
    e = fma_path::launch(qu, k, v, bi, m, l, out, d_out, dqu, dk_out, dv_out, db, dl, B, H,
                         T_len, drop, s);
  else if (dtype == 1)
    e = mma_path::launch(qu, k, v, bi, m, l, out, d_out, static_cast<float*>(dqu), dk_out,
                         dv_out, db, dl, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
