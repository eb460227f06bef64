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
// What bounds it: eight (T x T x 64) products per (batch, head), plus the
// recomputation of S and dPr in the second pass, against O(T) bytes:
// operations, on the bf16 tensor cores.
//
// Design. The TPU kernel is one sequential program per (batch, head) that
// carries dK, dV and dP in fast memory across query blocks and un-shears dS
// with log2 rolls. Here two kernels run after a row-dot pre-pass
// (flash_bwd_tile.cuh): the query pass owns 64 query rows, loops over key
// tiles and keeps dQ_u and dQ_v in registers (and adds dP); the key pass
// owns 64 keys, loops over query tiles and keeps dK and dV. Both recompute
// P from the LSE; dQ is written once, so everything but dP is
// deterministic. The dropout mask is philox.cuh's, a function of
// (seed, b*h, i, j), so both passes see the forward's mask.
//
// bf16 (dtype 1), `rel_bwd_{query,key}_pass_mma`: every product on mma.sync
// m16n8k16 with f32 accumulation (mma_tile.cuh); 4 warps of 16 query rows;
// cp.async into swizzled bf16 tiles; the window as a ring of three 64-row
// chunks, its next chunk loading while the current tile computes; S's
// position term as in rel_attention.cu (G = Q_v,w . Win_w^T read back along
// the diagonal). dS and P~ are rounded to bf16 as operands, f32 sums.
//   query pass  K, V double-buffered; Q_u and dO fragments in registers.
//               dQ_u += dS K from dS's registers. The position gradients go
//               through dG, a bf16 64 x 128 tile holding dS un-sheared,
//               dG[a, 63-a+j] = dS[a, j] (the forward's extraction inverted;
//               the positions off the band stay zero from the start):
//               dQ_v += dG_w . Win_w (16 x 80 x 64) and dWin = dG^T . Q_v
//               (128 x 64 x 64, over the 20 non-zero 16 x 16 blocks of the
//               band only). Warp w owns window blocks w and w+4 of dWin.
//               After key tile j, block w (table rows p0 + 16w ..) receives
//               nothing more from this block and is added to dP in device
//               memory, four floats per atomic; block w+4 is the next
//               tile's block w and stays in registers. So every block sends
//               each table row to memory once, not once per tile pair.
//               103.5 KB of shared memory: two blocks per SM.
//   key pass    K and V fixed; Q_u, Q_v, dO per query tile. Warps compute
//               dS and P~ of their 16 query rows and store them as bf16
//               tiles; then warp w accumulates dK and dV of keys 16w ..
//               from their transposes (ldmatrix .trans). 102.3 KB: two
//               blocks per SM. Only the window ring overlaps compute here:
//               Q_u, Q_v and dO of tile t+1 are single-buffered, issued
//               after tile t's last barrier and waited for at the top of
//               tile t+1, so each query tile waits on device memory. A
//               second stage of the three would add 24 KB (126.3 KB) and
//               leave one block per SM.
//
// f32 (dtype 0), `rel_bwd_{query,key}_pass`: the first version, kept
// unchanged on the CUDA cores (FP32 FMAs, f32 tiles, rel_tile.cuh; dP by one
// f32 atomic per element and tile pair), because the f32 path is held to
// 1e-4 against the CPU and TF32 cannot meet that.
//
// Bounds are checked: any T.

#include "flash_bwd_tile.cuh"
#include "mma_tile.cuh"
#include "rel_tile.cuh"

namespace {

namespace mma_path {

using namespace mma;

constexpr int kDgLd = 136;   // row stride (bf16) of the dG tile: ldmatrix without conflicts
// query pass: Q_v, two stages of K and of V, the window ring, dG, the
// warps' G scratch, two stages of mask flags
constexpr size_t kQPassSmem = ((size_t)8 * kTile + (size_t)kB * kDgLd) * sizeof(bf16) +
                              ((size_t)kWarps * 16 * kGld + 2 * kB) * sizeof(float);
// key pass: K, V, Q_u, Q_v, dO, the window ring, P~, dS, the G scratch, the mask flags
constexpr size_t kKPassSmem =
    (size_t)10 * kTile * sizeof(bf16) + ((size_t)kWarps * 16 * kGld + kB) * sizeof(float);

struct Args {
  const bf16 *qu, *qv, *k, *v, *p, *d_o;
  const uint8_t* mask;
  const float *lse, *delta;
  bf16 *dqu, *dqv, *dk, *dv;
  float* dp;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

__device__ __forceinline__ uint32_t dg_addr(const bf16* sDg, RC rc) {
  return smem_u32(sDg + rc.r * kDgLd + rc.c);
}

// The lane's two rows' log-sum-exp and D; rows past the sequence get
// lse = -inf (probabilities 0).
__device__ __forceinline__ void row_stats(const Args& g, int bh, int i_g, float lse[2],
                                          float delta[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    lse[r] = i < g.T_len ? g.lse[(size_t)bh * g.T_len + i] : -INFINITY;
    delta[r] = i < g.T_len ? g.delta[(size_t)bh * g.T_len + i] : 0.f;
  }
}

// From the scores s (scaled, mask not applied) and dpr = dO V^T of the
// warp's 16 x 64 pair tile: ds = P o (dpr * keep - D) * scale, and with pd
// != nullptr also pd = P * keep. Rows whose lse is below -1e30 / 2 had no
// valid key and get P = 0. kj0: the tile's first key.
__device__ __forceinline__ void backward_frag(float s[8][4], const float dpr[8][4],
                                              float (*pd)[4], const float* sM, const Args& g,
                                              int bh, int i_g, int kj0, const float lse[2],
                                              const float delta[2], int q) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float kf[4] = {1.f, 1.f, 1.f, 1.f};
    if (g.drop.thresh != 0u) keep_frag(g.drop, (uint32_t)bh, i_g, kj0 + 8 * n + 2 * q, q, kf);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool ok = lse[r] > 0.5f * flash::kMasked && sM[8 * n + 2 * q + (e & 1)] > 0.f;
      const float prob = ok ? expf(s[n][e] - lse[r]) : 0.f;
      if (pd != nullptr) pd[n][e] = prob * kf[e];
      s[n][e] = prob * (dpr[n][e] * kf[e] - delta[r]) * g.scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) rel_bwd_query_pass_mma(const Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQv = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQv + kTile;        // two stages
  bf16* sV = sK + 2 * kTile;     // two stages
  const Ring win{sV + 2 * kTile};
  bf16* sDg = win.s + 3 * kTile;                  // [query row][window row]
  float* sG = reinterpret_cast<float*>(sDg + kB * kDgLd);
  float* sM = sG + kWarps * 16 * kGld;            // two stages

  const int T_len = g.T_len, bh = blockIdx.y, h = bh % g.H, i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const int n_table = 2 * T_len - 1;
  const bf16* ph = g.p + (size_t)h * n_table * kD;
  float* dp_h = g.dp + (size_t)h * n_table * kD;
  const int p_base = T_len - 1 - (i0 + kB - 1);   // table row of window chunk 0
  const uint8_t* mask_row = g.mask + (size_t)(bh / g.H) * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int i_g = i0 + 16 * warp + (lane >> 2);
  float* G = sG + warp * 16 * kGld;
  const int n_tiles = (T_len + kB - 1) / kB;
  const int rb = 48 - 16 * warp;                  // first window row of the warp's rows

  // Q_u and dO pass through the dG tile on their way to registers
  load_tile(sDg, g.qu + base, i0, T_len);
  load_tile(sDg + kTile, g.d_o + base, i0, T_len);
  load_tile(sQv, g.qv + base, i0, T_len);
  load_tile(sK, g.k + base, 0, T_len);
  load_tile(sV, g.v + base, 0, T_len);
  load_tile(win.chunk(0), ph, p_base, n_table);
  load_tile(win.chunk(1), ph, p_base + kB, n_table);
  flash::load_mask(sM, mask_row, 0, T_len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t aqu[4][4], ado[4][4], aqv[4][4];
  load_a(aqu, sDg, 16 * warp, lane);
  load_a(ado, sDg + kTile, 16 * warp, lane);
  load_a(aqv, sQv, 16 * warp, lane);
  __syncthreads();
  for (int e = threadIdx.x; e < kB * kDgLd / 2; e += kThreads)
    reinterpret_cast<uint32_t*>(sDg)[e] = 0u;

  float lse[2], delta[2];
  row_stats(g, bh, i_g, lse, delta);
  float dqu[8][4], dqv[8][4], carry[8][4];
  zero(dqu);
  zero(dqv);
  zero(carry);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {       // stage t+1 was last read in tile t-1
      const int j1 = (t + 1) * kB;
      load_tile(sK + (st ^ 1) * kTile, g.k + base, j1, T_len);
      load_tile(sV + (st ^ 1) * kTile, g.v + base, j1, T_len);
      load_tile(win.chunk(t + 2), ph, p_base + (t + 2) * kB, n_table);
      flash::load_mask(sM + (st ^ 1) * kB, mask_row, j1, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sK + st * kTile;
    const bf16* vt = sV + st * kTile;

    float s[8][4], dpr[8][4];
    zero(s);
    zero(dpr);
    product_nt(s, aqu, kt, lane);
    add_position_term(s, aqv, win, t, warp, lane, G);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= g.scale;
    product_nt(dpr, ado, vt, lane);
    backward_frag(s, dpr, nullptr, sM + st * kB, g, bh, i_g, t * kB, lse, delta, q);

    // dS un-sheared into dG, then dQ_u += dS K
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 16 * warp + (lane >> 2) + 8 * (e >> 1), j = 8 * n + 2 * q + (e & 1);
        sDg[a * kDgLd + kB - 1 - a + j] = __float2bfloat16_rn(s[n][e]);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      to_a(a, s, kk);
      product_nn_step(dqu, a, kt, kk, lane);
    }
    __syncthreads();   // dG is complete

    // dQ_v += dG_w . Win_w: the warp's rows, window rows rb .. rb+79
#pragma unroll
    for (int ks = 0; ks < kGRows / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, dg_addr(sDg, a_rows(lane, 16 * warp, rb + 16 * ks)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, win.addr(t, b_cols(lane, 16 * np, rb + 16 * ks)));
        mma16816(dqv[2 * np], a, b[0], b[1]);
        mma16816(dqv[2 * np + 1], a, b[2], b[3]);
      }
    }
    // dWin = dG^T . Q_v on window blocks w (done: to dP) and w+4 (carried);
    // block b meets query k-steps s with 3 <= b + s <= 7 only
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = warp + 4 * half;
      float c[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = half == 0 ? carry[n][e] : 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (b + ks < 3 || b + ks > 7) continue;
        uint32_t a[4];
        ldsm_x4_t(a, dg_addr(sDg, a_cols(lane, 16 * b, 16 * ks)));
        product_nn_step(c, a, sQv, ks, lane);
      }
      if (half == 0) {
        red_add_rows(c, dp_h, p_base + t * kB + 16 * b, n_table, lane);
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) carry[n][e] = c[n][e];
      }
    }
    __syncthreads();   // stage st, window chunk t and dG are consumed
  }
  red_add_rows(carry, dp_h, p_base + n_tiles * kB + 16 * warp, n_table, lane);
  const float one[2] = {1.f, 1.f};
  store_rows(g.dqu + base, dqu, i_g, T_len, one, q);
  store_rows(g.dqv + base, dqv, i_g, T_len, one, q);
}

__global__ void __launch_bounds__(kThreads, 2) rel_bwd_key_pass_mma(const Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile;
  bf16* sQu = sV + kTile;
  bf16* sQv = sQu + kTile;
  bf16* sdO = sQv + kTile;
  const Ring win{sdO + kTile};
  bf16* sPd = win.s + 3 * kTile;  // P~ of the pair, [query][key]
  bf16* sdS = sPd + kTile;        // dS of the pair, [query][key]
  float* sG = reinterpret_cast<float*>(sdS + kTile);
  float* sM = sG + kWarps * 16 * kGld;

  const int T_len = g.T_len, bh = blockIdx.y, h = bh % g.H, j0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const int n_table = 2 * T_len - 1;
  const bf16* ph = g.p + (size_t)h * n_table * kD;
  // window of query tile t: chunks -t, -t+1, chunk m at table row p_base + 64m
  const int p_base = T_len - 1 - (kB - 1) + j0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  float* G = sG + warp * 16 * kGld;
  const int n_tiles = (T_len + kB - 1) / kB;

  load_tile(sK, g.k + base, j0, T_len);
  load_tile(sV, g.v + base, j0, T_len);
  flash::load_mask(sM, g.mask + (size_t)(bh / g.H) * T_len, j0, T_len);
  load_tile(win.chunk(0), ph, p_base, n_table);
  load_tile(win.chunk(1), ph, p_base + kB, n_table);
  load_tile(sQu, g.qu + base, 0, T_len);
  load_tile(sQv, g.qv + base, 0, T_len);
  load_tile(sdO, g.d_o + base, 0, T_len);
  cp_async_commit();

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  for (int t = 0; t < n_tiles; ++t) {
    const int i_g = t * kB + 16 * warp + (lane >> 2);
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {       // chunk -(t+1) shares its slot with -t+2, last read in tile t-1
      load_tile(win.chunk(-(t + 1)), ph, p_base - (t + 1) * kB, n_table);
      cp_async_commit();
    }
    float lse[2], delta[2];
    row_stats(g, bh, i_g, lse, delta);

    float s[8][4], dpr[8][4], pd[8][4];
    zero(s);
    zero(dpr);
    {
      uint32_t a[4][4];
      load_a(a, sQu, 16 * warp, lane);
      product_nt(s, a, sK, lane);
      load_a(a, sQv, 16 * warp, lane);
      add_position_term(s, a, win, -t, warp, lane, G);
      load_a(a, sdO, 16 * warp, lane);
      product_nt(dpr, a, sV, lane);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= g.scale;
    backward_frag(s, dpr, pd, sM, g, bh, i_g, j0, lse, delta, q);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = 16 * warp + (lane >> 2) + 8 * h2, c = 8 * n + 2 * q;
        *reinterpret_cast<uint32_t*>(sPd + swz(r, c)) = pack_bf16(pd[n][2 * h2], pd[n][2 * h2 + 1]);
        *reinterpret_cast<uint32_t*>(sdS + swz(r, c)) = pack_bf16(s[n][2 * h2], s[n][2 * h2 + 1]);
      }
    __syncthreads();
    // warp w: keys 16w ..; dV += P~^T dO, dK += dS^T Q_u over the 64 query rows
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      ldsm_x4_t(a, tile_addr(sPd, a_cols(lane, 16 * warp, 16 * ks)));
      product_nn_step(dv, a, sdO, ks, lane);
      ldsm_x4_t(a, tile_addr(sdS, a_cols(lane, 16 * warp, 16 * ks)));
      product_nn_step(dk, a, sQu, ks, lane);
    }
    __syncthreads();   // Q_u, Q_v, dO, P~ and dS are consumed
    if (t + 1 < n_tiles) {
      const int i1 = (t + 1) * kB;
      load_tile(sQu, g.qu + base, i1, T_len);
      load_tile(sQv, g.qv + base, i1, T_len);
      load_tile(sdO, g.d_o + base, i1, T_len);
      cp_async_commit();
    }
  }
  const float one[2] = {1.f, 1.f};
  const int j_g = j0 + 16 * warp + (lane >> 2);
  store_rows(g.dk + base, dk, j_g, T_len, one, q);
  store_rows(g.dv + base, dv, j_g, T_len, one, q);
}

cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   void* dqu, void* dqv, void* dk, void* dv, float* dp, float* delta, int B,
                   int H, int T_len, philox::Dropout drop, cudaStream_t stream) {
  if (!aligned16({qu, qv, k, v, p, d_o, dp})) return cudaErrorMisalignedAddress;
  cudaError_t e = flash::launch_row_dot<bf16>(out, d_o, delta, (size_t)B * H * T_len, stream);
  if (e != cudaSuccess) return e;
  Args g;
  g.qu = static_cast<const bf16*>(qu);
  g.qv = static_cast<const bf16*>(qv);
  g.k = static_cast<const bf16*>(k);
  g.v = static_cast<const bf16*>(v);
  g.p = static_cast<const bf16*>(p);
  g.d_o = static_cast<const bf16*>(d_o);
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = static_cast<bf16*>(dqu);
  g.dqv = static_cast<bf16*>(dqv);
  g.dk = static_cast<bf16*>(dk);
  g.dv = static_cast<bf16*>(dv);
  g.dp = dp;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  e = cudaFuncSetAttribute(rel_bwd_query_pass_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kQPassSmem);
  if (e != cudaSuccess) return e;
  rel_bwd_query_pass_mma<<<grid, kThreads, kQPassSmem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(rel_bwd_key_pass_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kKPassSmem);
  if (e != cudaSuccess) return e;
  rel_bwd_key_pass_mma<<<grid, kThreads, kKPassSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace mma_path

namespace fma_path {

using namespace flash;

// query pass: Q_u, Q_v, dO, K, V, dS tiles, the window, the mask flags
constexpr size_t kQPassSmem = ((size_t)(6 * kB + kWin) * kS + kB) * sizeof(float);
// key pass: K, V, Q_u, Q_v, dO, dS, P~ tiles, the window, the mask flags
constexpr size_t kKPassSmem = ((size_t)(7 * kB + kWin) * kS + kB) * sizeof(float);

struct Args {
  const float *qu, *qv, *k, *v, *p, *d_o;
  const uint8_t* mask;
  const float *lse, *delta;
  float *dqu, *dqv, *dk, *dv;
  float* dp;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

__global__ void __launch_bounds__(kThreads) rel_bwd_query_pass(const Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQu = reinterpret_cast<float*>(smem_raw);
  float* sQv = sQu + kB * kS;
  float* sdO = sQv + kB * kS;
  float* sK = sdO + kB * kS;
  float* sV = sK + kB * kS;
  float* sS = sV + kB * kS;      // dS of the pair
  float* sP = sS + kB * kS;      // position-table window
  float* sM = sP + kWin * kS;

  const int T_len = g.T_len;
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* ph = g.p + (size_t)h * (2 * T_len - 1) * kD;
  float* dp_h = g.dp + (size_t)h * (2 * T_len - 1) * kD;
  const uint8_t* mask_row = g.mask + (size_t)(bh / g.H) * T_len;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sQu, g.qu + base, i0, T_len);
  load_tile(sQv, g.qv + base, i0, T_len);
  load_tile(sdO, g.d_o + base, i0, T_len);
  float lse[4], delta[4];
  load_row_stats(g.lse + (size_t)bh * T_len, g.delta + (size_t)bh * T_len, i0, T_len, ty, lse,
                 delta);
  float dqu[4][4], dqv[4][4];
  zero_tile(dqu);
  zero_tile(dqv);

  for (int j0 = 0; j0 < T_len; j0 += kB) {
    const int p0 = window_start(T_len, i0, j0);
    __syncthreads();  // the previous pair's dS, keys and window are consumed
    load_tile(sK, g.k + base, j0, T_len);
    load_tile(sV, g.v + base, j0, T_len);
    load_window(sP, ph, p0, T_len);
    load_mask(sM, mask_row, j0, T_len);
    __syncthreads();

    float s[4][4], dpr[4][4], keep[4][4], ds[4][4], pd[4][4];
    rel_scores(sQu, sQv, sK, sP, ty, tx, g.scale, s);
    qk_product(sdO, sV, ty, tx, dpr);
    keep_tile(g.drop, bh, i0, j0, ty, tx, keep);
    backward_tile(s, sM, tx, lse, delta, keep, dpr, ds, pd);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[a][j] *= g.scale;
    store_tile(sS, ty, tx, ds);
    __syncthreads();
    rows_product(sS, sK, ty, tx, dqu);
    band_rows_product(sS, sP, ty, tx, dqv);
    band_scatter(sS, sQv, ty, tx, dp_h, p0, T_len);
  }
  write_grad(g.dqu + base, i0, T_len, ty, tx, dqu);
  write_grad(g.dqv + base, i0, T_len, ty, tx, dqv);
}

__global__ void __launch_bounds__(kThreads) rel_bwd_key_pass(const Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kB * kS;
  float* sQu = sV + kB * kS;
  float* sQv = sQu + kB * kS;
  float* sdO = sQv + kB * kS;
  float* sS = sdO + kB * kS;     // dS of the pair
  float* sPd = sS + kB * kS;     // dropped probabilities of the pair
  float* sP = sPd + kB * kS;     // position-table window
  float* sM = sP + kWin * kS;

  const int T_len = g.T_len;
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int j0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* ph = g.p + (size_t)h * (2 * T_len - 1) * kD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sK, g.k + base, j0, T_len);
  load_tile(sV, g.v + base, j0, T_len);
  load_mask(sM, g.mask + (size_t)(bh / g.H) * T_len, j0, T_len);
  float dk[4][4], dv[4][4];
  zero_tile(dk);
  zero_tile(dv);

  for (int i0 = 0; i0 < T_len; i0 += kB) {
    __syncthreads();  // the previous pair's tiles are consumed
    load_tile(sQu, g.qu + base, i0, T_len);
    load_tile(sQv, g.qv + base, i0, T_len);
    load_tile(sdO, g.d_o + base, i0, T_len);
    load_window(sP, ph, window_start(T_len, i0, j0), T_len);
    float lse[4], delta[4];
    load_row_stats(g.lse + (size_t)bh * T_len, g.delta + (size_t)bh * T_len, i0, T_len, ty,
                   lse, delta);
    __syncthreads();

    float s[4][4], dpr[4][4], keep[4][4], ds[4][4], pd[4][4];
    rel_scores(sQu, sQv, sK, sP, ty, tx, g.scale, s);
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
    cols_product(sS, sQu, ty, tx, dk);
    cols_product(sPd, sdO, ty, tx, dv);
  }
  write_grad(g.dk + base, j0, T_len, ty, tx, dk);
  write_grad(g.dv + base, j0, T_len, ty, tx, dv);
}

cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   void* dqu, void* dqv, void* dk, void* dv, float* dp, float* delta, int B,
                   int H, int T_len, philox::Dropout drop, cudaStream_t stream) {
  cudaError_t e = launch_row_dot<float>(out, d_o, delta, (size_t)B * H * T_len, stream);
  if (e != cudaSuccess) return e;
  Args g;
  g.qu = static_cast<const float*>(qu);
  g.qv = static_cast<const float*>(qv);
  g.k = static_cast<const float*>(k);
  g.v = static_cast<const float*>(v);
  g.p = static_cast<const float*>(p);
  g.d_o = static_cast<const float*>(d_o);
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = static_cast<float*>(dqu);
  g.dqv = static_cast<float*>(dqv);
  g.dk = static_cast<float*>(dk);
  g.dv = static_cast<float*>(dv);
  g.dp = dp;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  auto q_pass = rel_bwd_query_pass;
  e = cudaFuncSetAttribute(q_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kQPassSmem);
  if (e != cudaSuccess) return e;
  q_pass<<<grid, kThreads, kQPassSmem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto k_pass = rel_bwd_key_pass;
  e = cudaFuncSetAttribute(k_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kKPassSmem);
  if (e != cudaSuccess) return e;
  k_pass<<<grid, kThreads, kKPassSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace fma_path

}  // namespace

// All tensors contiguous. q_u, q_v, k, v, out, d_out and the gradients dq_u,
// dq_v, dk, dv: (B, H, T, dk) of the input type; p (H, 2T-1, dk); mask (B, T)
// uint8; lse (B, H, T) float32 from the forward. dp: float32 (H, 2T-1, dk),
// zeroed by the caller, receives the position table's gradient. delta:
// float32 (B, H, T) scratch. dtype: 0 = float32 (FMA kernels), 1 = bfloat16
// (tensor-core kernels; pointers 16-byte aligned). Only dk = 64.
// rate and seed as given to the forward. Returns cudaGetLastError() after
// the launches.
extern "C" int l2s_rel_attention_bwd(const void* qu, const void* qv, const void* k,
                                     const void* v, const void* p, const void* mask,
                                     const void* lse, const void* out, const void* d_out,
                                     void* dqu, void* dqv, void* dk_out, void* dv_out, void* dp,
                                     void* delta, int B, int H, int T_len, int dk, int dtype,
                                     float rate, unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* dpf = static_cast<float*>(dp);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  cudaError_t e;
  if (dtype == 0)
    e = fma_path::launch(qu, qv, k, v, p, m, l, out, d_out, dqu, dqv, dk_out, dv_out, dpf, dl,
                         B, H, T_len, drop, s);
  else if (dtype == 1)
    e = mma_path::launch(qu, qv, k, v, p, m, l, out, d_out, dqu, dqv, dk_out, dv_out, dpf, dl, B,
                         H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
