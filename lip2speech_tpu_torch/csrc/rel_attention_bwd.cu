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
// operations, on the tensor cores (bf16; f32 in 3xTF32).
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
// Both passes are templates over the input type, `rel_bwd_{query,key}_pass
// _mma<T>`: one tile loop; the type picks the tiles, the products, the warp
// layout and the layouts of the tiles the kernels write themselves (dG, P~,
// dS). Every product runs on the tensor cores, in bf16 on mma.sync
// m16n8k16 and in f32 in 3xTF32 on m16n8k8 (mma_tile.cuh: hi, lo = v - hi,
// three products each, f32 accumulate; ~2^-21 of |a b| dropped, so the f32
// path is held to 1e-4 of the plain version, where one TF32 product, ~1e-3
// off, would not pass). cp.async into operand tiles; the window as a ring
// of three 64-row chunks, its next chunk loading while the current tile
// computes. S's position term as in rel_attention.cu (G = Q_v . Win^T read
// back along the diagonal). bf16: 4 warps of 16 query rows (keys, in the
// key pass), each against the whole tile; dS and P~ are rounded to bf16 as
// operands, f32 sums. f32: 8 warps, two to each 16 rows, each taking half
// the tile's keys (S, dPr, dS, P~) and then half the channels of the
// products that follow: one f32 block fills an SM's shared memory, and a
// block of 4 warps left the schedulers one warp each, bound by latency.
//   query pass  K, V double-buffered. The position gradients go through
//               dG, a 64 x 128 tile holding dS un-sheared, dG[a, 63-a+j] =
//               dS[a, j] (the forward's extraction inverted; the positions
//               off the band stay zero from the start): dQ_v += dG_w .
//               Win_w (16 x 80 x 64) and dWin = dG^T . Q_v (128 x 64 x 64,
//               over the 20 non-zero 16 x 16 blocks of the band only).
//               Rows 16w own window blocks w and w+4 of dWin. After key
//               tile j, block w (table rows p0 + 16w ..) receives nothing
//               more from this block and is added to dP in device memory,
//               four floats per atomic; block w+4 is the next tile's block
//               w and stays in registers. So every block sends each table
//               row to memory once, not once per tile pair. Q_u and dO are
//               staged through dG into registers. bf16: dQ_u += dS K from
//               dS's registers; Q_v fragments in registers; 103.5 KB, two
//               blocks per SM. f32: dQ_u += dS K with dS read back out of
//               dG (the keys of a k8 step in the order 0, 2, 4, 6, 1, 3, 5,
//               7, K's rows read by single floats to match); dG f32 with a
//               row stride of 136 floats, read as A by float2 (dQ_v, the
//               window rows in that order) and by single floats (dWin^T);
//               Q_u and dO held unsplit, Q_v read from its tile at each
//               use; 198.5 KB, one block of 8 warps per SM.
//   key pass    K and V fixed; Q_u, Q_v, dO per query tile. Warps compute
//               dS and P~ of their rows and keys and store them to tiles;
//               then the warps of keys 16w .. accumulate dK and dV from
//               their transposes: bf16 tiles [query][key] read by ldmatrix
//               .trans; f32 tiles stored transposed, [key][query] at a row
//               stride of 72, read as A by float2 in the k8 order above,
//               with dO's and Q_u's rows read to match. Only the window
//               ring overlaps compute here: Q_u, Q_v and dO of tile t+1 are
//               single-buffered, issued after tile t's last barrier and
//               waited for at the top of tile t+1, so each query tile waits
//               on device memory. bf16: 102.3 KB, two blocks per SM (a
//               second stage of the three would add 24 KB and leave one);
//               f32: 200.3 KB, one block of 8 warps per SM.
//
// Bounds are checked: any T.

#include "flash_bwd_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma;

constexpr int kDgLd = 136;   // row stride of the dG tile (bf16: ldmatrix without conflicts)
constexpr int kPtLd = 72;    // row stride of the f32 P~^T and dS^T tiles

// bf16: 4 warps, each owning 16 query rows (query pass) or keys (key pass)
// against the whole tile. f32: 8 warps, two to each 16 rows, each taking
// half the tile's keys (kw = 0 or 32) and, in the products that follow,
// half the channels: the 3xTF32 products leave one 4-warp block of ~200 KB
// an SM latency-bound, and two warps a scheduler hide each other's waits.
template <typename T>
struct Pass {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kWarps = kBf16 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NT = kBf16 ? 8 : 4;         // n8 tiles of keys (and channels) a warp
  static constexpr int kGLd = kBf16 ? kGld : 56;   // row stride of a warp's G scratch
  static constexpr int E = Tile<T>::kElems;
  // query pass: Q_v, two stages of K and of V, the window ring, dG (Q_u
  // and dO pass through it on their way to registers), the warps' G
  // scratch, two stages of mask flags
  static constexpr size_t kQSmem = ((size_t)8 * E + (size_t)kB * kDgLd) * sizeof(T) +
                                   ((size_t)kWarps * 16 * kGLd + 2 * kB) * sizeof(float);
  // key pass: K, V, Q_u, Q_v, dO, the window ring, P~, dS, the G scratch, the mask flags
  static constexpr int kPdElems = kBf16 ? kTile : kD * kPtLd;
  static constexpr size_t kKSmem = ((size_t)8 * E + 2 * (size_t)kPdElems) * sizeof(T) +
                                   ((size_t)kWarps * 16 * kGLd + kB) * sizeof(float);
  static constexpr int kBlocksPerSm = kBf16 ? 2 : 1;
};

template <typename T>
struct Args {
  const T *qu, *qv, *k, *v, *p, *d_o;
  const uint8_t* mask;
  const float *lse, *delta;
  T *dqu, *dqv, *dk, *dv;
  float* dp;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

__device__ __forceinline__ void put(bf16* dst, float v) { *dst = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

__device__ __forceinline__ uint32_t dg_addr(const bf16* sDg, RC rc) {
  return smem_u32(sDg + rc.r * kDgLd + rc.c);
}

// The lane's two rows' log-sum-exp and D; rows past the sequence get
// lse = -inf (probabilities 0).
template <typename T>
__device__ __forceinline__ void row_stats(const Args<T>& g, int bh, int i_g, float lse[2],
                                          float delta[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    lse[r] = i < g.T_len ? g.lse[(size_t)bh * g.T_len + i] : -INFINITY;
    delta[r] = i < g.T_len ? g.delta[(size_t)bh * g.T_len + i] : 0.f;
  }
}

// From the scores s (scaled, mask not applied) and dpr = dO V^T of the
// warp's 16 x 8 NT pair tile: ds = P o (dpr * keep - D) * scale, and with
// pd != nullptr also pd = P * keep. Rows whose lse is below -1e30 / 2 had
// no valid key and get P = 0. kj0: the warp's first key; sM: its flags.
template <int NT, typename T>
__device__ __forceinline__ void backward_frag(float s[][4], const float dpr[][4], float (*pd)[4],
                                              const float* sM, const Args<T>& g, int bh, int i_g,
                                              int kj0, const float lse[2], const float delta[2],
                                              int q) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
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

// The query pass's products after dG is complete, for the warp's 16 query
// rows 16w.. (its window rows rb .. rb+79):
//   dQ_v += dG_w . Win_w,  dWin on window blocks w (done: to dP) and w+4
//   (carried); block b meets query k-steps s with 3 <= b + s <= 7 only.
// bf16: all 64 channels (cc = 0), dQ_u already added from dS's registers;
// f32: channels 32 cc .., and dQ_u += dS K from dS read back out of dG.
__device__ __forceinline__ void band_dqv(float dqv[8][4], const bf16* sDg, const Ring<bf16>& win,
                                         int m, int w, int, int lane) {
  const int rb = 48 - 16 * w;
#pragma unroll
  for (int ks = 0; ks < kGRows / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, dg_addr(sDg, a_rows(lane, 16 * w, rb + 16 * ks)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, win.addr(m, b_cols(lane, 16 * np, rb + 16 * ks)));
      mma16816(dqv[2 * np], a, b[0], b[1]);
      mma16816(dqv[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void band_dqv(float dqv[4][4], const float* sDg,
                                         const Ring<float>& win, int m, int w, int cc, int lane) {
  const int rb = 48 - 16 * w, g = lane >> 2, q = lane & 3;
  const float* d0 = sDg + (16 * w + g) * kDgLd + rb + 2 * q;
#pragma unroll 2
  for (int ks = 0; ks < kGRows / 8; ++ks) {
    const float2 x0 = *reinterpret_cast<const float2*>(d0 + 8 * ks);
    const float2 x1 = *reinterpret_cast<const float2*>(d0 + 8 * kDgLd + 8 * ks);
    const uint32_t av[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x), __float_as_uint(x0.y),
                            __float_as_uint(x1.y)};
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    split4(av, ah, al);
    // window rows 2q, 2q + 1 of the step, channels 32 cc ..
    load_b_cols<4>(bh, bl, win.row(m, rb + 8 * ks + 2 * q) + 32 * cc + g);
    mma3_tiles<4>(dqv, ah, al, bh, bl);
  }
}

// f32: dQ_u (rows 16w.., channels 32 cc ..) += dS K, with dS[a][j] =
// dG[a][63 - a + j] (the keys of a k8 step in the order 0, 2, 4, 6, 1, 3,
// 5, 7, K's rows read to match)
__device__ __forceinline__ void dqu_from_dg(float dqu[4][4], const float* sDg, const float* kt,
                                            int w, int cc, int lane) {
  const int g = lane >> 2, q = lane & 3, a = 16 * w + g;
  const float* d0 = sDg + a * kDgLd + kB - 1 - a + 2 * q;             // row a, key 2q
  const float* d1 = sDg + (a + 8) * kDgLd + kB - 1 - (a + 8) + 2 * q;   // row a + 8
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    const uint32_t av[4] = {__float_as_uint(d0[8 * ks]), __float_as_uint(d1[8 * ks]),
                            __float_as_uint(d0[8 * ks + 1]), __float_as_uint(d1[8 * ks + 1])};
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    split4(av, ah, al);
    load_b_cols<4>(bh, bl, kt + (8 * ks + 2 * q) * kLd32 + 32 * cc + g);
    mma3_tiles<4>(dqu, ah, al, bh, bl);
  }
}

// c += dWin of window block b (rows 16b..16b+15) = dG[:, block b]^T . Q_v
// (f32: channels 32 cc ..)
__device__ __forceinline__ void band_dwin(float c[8][4], const bf16* sDg, const bf16* sQv, int b,
                                          int, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (b + ks < 3 || b + ks > 7) continue;
    uint32_t a[4];
    ldsm_x4_t(a, dg_addr(sDg, a_cols(lane, 16 * b, 16 * ks)));
    product_nn_step(c, a, sQv, ks, lane);
  }
}

__device__ __forceinline__ void band_dwin(float c[4][4], const float* sDg, const float* sQv,
                                          int b, int cc, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (b + ks < 3 || b + ks > 7) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = 16 * ks + 8 * h;   // queries k0 + 2q, k0 + 2q + 1
      const float* d0 = sDg + (k0 + 2 * q) * kDgLd + 16 * b + g;
      const uint32_t av[4] = {__float_as_uint(d0[0]), __float_as_uint(d0[8]),
                              __float_as_uint(d0[kDgLd]), __float_as_uint(d0[kDgLd + 8])};
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      split4(av, ah, al);
      load_b_cols<4>(bh, bl, sQv + (k0 + 2 * q) * kLd32 + 32 * cc + g);
      mma3_tiles<4>(c, ah, al, bh, bl);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Pass<T>::kThreads, Pass<T>::kBlocksPerSm)
rel_bwd_query_pass_mma(const Args<T> g) {
  using P = Pass<T>;
  constexpr int E = P::E, NT = P::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQv = reinterpret_cast<T*>(smem_raw);
  T* sK = sQv + E;               // two stages
  T* sV = sK + 2 * E;            // two stages
  const Ring<T> win{sV + 2 * E};
  T* sDg = win.s + 3 * E;        // [query row][window row]
  float* sG = reinterpret_cast<float*>(sDg + kB * kDgLd);
  float* sM = sG + P::kWarps * 16 * P::kGLd;   // two stages

  const int T_len = g.T_len, bh = blockIdx.y, h = bh % g.H, i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const int n_table = 2 * T_len - 1;
  const T* ph = g.p + (size_t)h * n_table * kD;
  float* dp_h = g.dp + (size_t)h * n_table * kD;
  const int p_base = T_len - 1 - (i0 + kB - 1);   // table row of window chunk 0
  const uint8_t* mask_row = g.mask + (size_t)(bh / g.H) * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int w = warp & 3, cc = warp >> 2, kw = 8 * NT * cc;   // rows 16w..; keys kw..
  const int i_g = i0 + 16 * w + (lane >> 2);
  float* G = sG + warp * 16 * P::kGLd;
  const int n_tiles = (T_len + kB - 1) / kB;

  // Q_u and dO pass through the dG tile on their way to registers
  load_tile<P::kThreads>(sDg, g.qu + base, i0, T_len);
  load_tile<P::kThreads>(sDg + E, g.d_o + base, i0, T_len);
  load_tile<P::kThreads>(sQv, g.qv + base, i0, T_len);
  load_tile<P::kThreads>(sK, g.k + base, 0, T_len);
  load_tile<P::kThreads>(sV, g.v + base, 0, T_len);
  load_tile<P::kThreads>(win.chunk(0), ph, p_base, n_table);
  load_tile<P::kThreads>(win.chunk(1), ph, p_base + kB, n_table);
  flash::load_mask(sM, mask_row, 0, T_len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  RowsA<T> aqu, ado;
  PassRowsA<T> aqv;
  aqu.init(sDg, 16 * w, lane);
  ado.init(sDg + E, 16 * w, lane);
  aqv.init(sQv, 16 * w, lane);
  __syncthreads();
  for (int e = threadIdx.x; e < kB * kDgLd * (int)sizeof(T) / 4; e += P::kThreads)
    reinterpret_cast<uint32_t*>(sDg)[e] = 0u;

  float lse[2], delta[2];
  row_stats(g, bh, i_g, lse, delta);
  float dqu[NT][4], dqv[NT][4], carry[NT][4];
  zero<NT>(dqu);
  zero<NT>(dqv);
  zero<NT>(carry);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {       // stage t+1 was last read in tile t-1
      const int j1 = (t + 1) * kB;
      load_tile<P::kThreads>(sK + (st ^ 1) * E, g.k + base, j1, T_len);
      load_tile<P::kThreads>(sV + (st ^ 1) * E, g.v + base, j1, T_len);
      load_tile<P::kThreads>(win.chunk(t + 2), ph, p_base + (t + 2) * kB, n_table);
      flash::load_mask(sM + (st ^ 1) * kB, mask_row, j1, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = sK + st * E;
    const T* vt = sV + st * E;

    float s[NT][4], dpr[NT][4];
    zero<NT>(s);
    zero<NT>(dpr);
    product_nt<NT>(s, aqu, kt + Tile<T>::at(kw, 0), lane);
    add_position_term<NT, P::kGLd>(s, aqv, win, t, 48 - 16 * w + kw, lane, G);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= g.scale;
    product_nt<NT>(dpr, ado, vt + Tile<T>::at(kw, 0), lane);
    backward_frag<NT>(s, dpr, nullptr, sM + st * kB + kw, g, bh, i_g, t * kB + kw, lse, delta, q);

    // dS un-sheared into dG (bf16: and dQ_u += dS K from the registers)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 16 * w + (lane >> 2) + 8 * (e >> 1), j = kw + 8 * n + 2 * q + (e & 1);
        put(sDg + a * kDgLd + kB - 1 - a + j, s[n][e]);
      }
    if constexpr (P::kBf16) product_acc_nn(dqu, s, kt, lane);
    __syncthreads();   // dG is complete

    if constexpr (!P::kBf16) dqu_from_dg(dqu, sDg, kt, w, cc, lane);
    band_dqv(dqv, sDg, win, t, w, cc, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = w + 4 * half;
      float c[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = half == 0 ? carry[n][e] : 0.f;
      band_dwin(c, sDg, sQv, b, cc, lane);
      if (half == 0) {
        red_add_rows<NT>(c, dp_h + 8 * NT * cc, p_base + t * kB + 16 * b, n_table, lane);
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) carry[n][e] = c[n][e];
      }
    }
    __syncthreads();   // stage st, window chunk t and dG are consumed
  }
  red_add_rows<NT>(carry, dp_h + 8 * NT * cc, p_base + n_tiles * kB + 16 * w, n_table, lane);
  const float one[2] = {1.f, 1.f};
  store_rows<NT>(g.dqu + base + 8 * NT * cc, dqu, i_g, T_len, one, q);
  store_rows<NT>(g.dqv + base + 8 * NT * cc, dqv, i_g, T_len, one, q);
}

// P~ and dS of the warp's rows (16w..) and keys (kw..) into the pair's
// tiles: bf16 [query][key] (swizzled), f32 transposed, [key][query] at a
// row stride of kPtLd.
__device__ __forceinline__ void store_pair(bf16* sPd, bf16* sdS, const float pd[8][4],
                                           const float ds[8][4], int w, int, int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = 16 * w + (lane >> 2) + 8 * h2, c = 8 * n + 2 * q;
      *reinterpret_cast<uint32_t*>(sPd + swz(r, c)) = pack_bf16(pd[n][2 * h2], pd[n][2 * h2 + 1]);
      *reinterpret_cast<uint32_t*>(sdS + swz(r, c)) = pack_bf16(ds[n][2 * h2], ds[n][2 * h2 + 1]);
    }
}

__device__ __forceinline__ void store_pair(float* sPd, float* sdS, const float pd[4][4],
                                           const float ds[4][4], int w, int kw, int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + (lane >> 2) + 8 * (e >> 1), c = kw + 8 * n + 2 * q + (e & 1);
      sPd[c * kPtLd + r] = pd[n][e];
      sdS[c * kPtLd + r] = ds[n][e];
    }
}

// dV += P~^T dO, dK += dS^T Q_u over the 64 query rows, for keys 16w ..
// (f32: and channels 32 cc ..)
__device__ __forceinline__ void key_products(float dv[8][4], float dk[8][4], const bf16* sPd,
                                             const bf16* sdS, const bf16* sdO, const bf16* sQu,
                                             int w, int, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    ldsm_x4_t(a, tile_addr(sPd, a_cols(lane, 16 * w, 16 * ks)));
    product_nn_step(dv, a, sdO, ks, lane);
    ldsm_x4_t(a, tile_addr(sdS, a_cols(lane, 16 * w, 16 * ks)));
    product_nn_step(dk, a, sQu, ks, lane);
  }
}

// The A of the warp's 16 keys x queries k0 + 2q, k0 + 2q + 1 (k8 order) of
// a transposed f32 tile, split.
__device__ __forceinline__ void key_rows_a(const float* tile, int w, int k0, int lane,
                                           uint32_t ah[4], uint32_t al[4]) {
  const float* r = tile + (16 * w + (lane >> 2)) * kPtLd + k0 + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(r);
  const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * kPtLd);
  const uint32_t av[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x), __float_as_uint(x0.y),
                          __float_as_uint(x1.y)};
  split4(av, ah, al);
}

__device__ __forceinline__ void key_products(float dv[4][4], float dk[4][4], const float* sPd,
                                             const float* sdS, const float* sdO,
                                             const float* sQu, int w, int cc, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    // query rows 2q, 2q + 1 of the step, channels 32 cc ..
    const int row = (8 * ks + 2 * q) * kLd32 + 32 * cc + g;
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    key_rows_a(sPd, w, 8 * ks, lane, ah, al);
    load_b_cols<4>(bh, bl, sdO + row);
    mma3_tiles<4>(dv, ah, al, bh, bl);
    key_rows_a(sdS, w, 8 * ks, lane, ah, al);
    load_b_cols<4>(bh, bl, sQu + row);
    mma3_tiles<4>(dk, ah, al, bh, bl);
  }
}

template <typename T>
__global__ void __launch_bounds__(Pass<T>::kThreads, Pass<T>::kBlocksPerSm)
rel_bwd_key_pass_mma(const Args<T> g) {
  using P = Pass<T>;
  constexpr int E = P::E, NT = P::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + E;
  T* sQu = sV + E;
  T* sQv = sQu + E;
  T* sdO = sQv + E;
  const Ring<T> win{sdO + E};
  T* sPd = win.s + 3 * E;           // P~ of the pair
  T* sdS = sPd + P::kPdElems;       // dS of the pair
  float* sG = reinterpret_cast<float*>(sdS + P::kPdElems);
  float* sM = sG + P::kWarps * 16 * P::kGLd;

  const int T_len = g.T_len, bh = blockIdx.y, h = bh % g.H, j0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const int n_table = 2 * T_len - 1;
  const T* ph = g.p + (size_t)h * n_table * kD;
  // window of query tile t: chunks -t, -t+1, chunk m at table row p_base + 64m
  const int p_base = T_len - 1 - (kB - 1) + j0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int w = warp & 3, cc = warp >> 2, kw = 8 * NT * cc;   // rows (keys) 16w..; keys kw..
  float* G = sG + warp * 16 * P::kGLd;
  const int n_tiles = (T_len + kB - 1) / kB;

  load_tile<P::kThreads>(sK, g.k + base, j0, T_len);
  load_tile<P::kThreads>(sV, g.v + base, j0, T_len);
  flash::load_mask(sM, g.mask + (size_t)(bh / g.H) * T_len, j0, T_len);
  load_tile<P::kThreads>(win.chunk(0), ph, p_base, n_table);
  load_tile<P::kThreads>(win.chunk(1), ph, p_base + kB, n_table);
  load_tile<P::kThreads>(sQu, g.qu + base, 0, T_len);
  load_tile<P::kThreads>(sQv, g.qv + base, 0, T_len);
  load_tile<P::kThreads>(sdO, g.d_o + base, 0, T_len);
  cp_async_commit();

  float dk[NT][4], dv[NT][4];
  zero<NT>(dk);
  zero<NT>(dv);

  for (int t = 0; t < n_tiles; ++t) {
    const int i_g = t * kB + 16 * w + (lane >> 2);
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {       // chunk -(t+1) shares its slot with -t+2, last read in tile t-1
      load_tile<P::kThreads>(win.chunk(-(t + 1)), ph, p_base - (t + 1) * kB, n_table);
      cp_async_commit();
    }
    float lse[2], delta[2];
    row_stats(g, bh, i_g, lse, delta);

    float s[NT][4], dpr[NT][4], pd[NT][4];
    zero<NT>(s);
    zero<NT>(dpr);
    {
      PassRowsA<T> a;
      a.init(sQu, 16 * w, lane);
      product_nt<NT>(s, a, sK + Tile<T>::at(kw, 0), lane);
      a.init(sQv, 16 * w, lane);
      add_position_term<NT, P::kGLd>(s, a, win, -t, 48 - 16 * w + kw, lane, G);
      a.init(sdO, 16 * w, lane);
      product_nt<NT>(dpr, a, sV + Tile<T>::at(kw, 0), lane);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= g.scale;
    backward_frag<NT>(s, dpr, pd, sM + kw, g, bh, i_g, j0 + kw, lse, delta, q);
    store_pair(sPd, sdS, pd, s, w, kw, lane);
    __syncthreads();
    key_products(dv, dk, sPd, sdS, sdO, sQu, w, cc, lane);
    __syncthreads();   // Q_u, Q_v, dO, P~ and dS are consumed
    if (t + 1 < n_tiles) {
      const int i1 = (t + 1) * kB;
      load_tile<P::kThreads>(sQu, g.qu + base, i1, T_len);
      load_tile<P::kThreads>(sQv, g.qv + base, i1, T_len);
      load_tile<P::kThreads>(sdO, g.d_o + base, i1, T_len);
      cp_async_commit();
    }
  }
  const float one[2] = {1.f, 1.f};
  const int j_g = j0 + 16 * w + (lane >> 2);
  store_rows<NT>(g.dk + base + 8 * NT * cc, dk, j_g, T_len, one, q);
  store_rows<NT>(g.dv + base + 8 * NT * cc, dv, j_g, T_len, one, q);
}

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   void* dqu, void* dqv, void* dk, void* dv, float* dp, float* delta, int B,
                   int H, int T_len, philox::Dropout drop, cudaStream_t stream) {
  if (!aligned16({qu, qv, k, v, p, d_o, dp, dqu, dqv, dk, dv})) return cudaErrorMisalignedAddress;
  cudaError_t e = flash::launch_row_dot<T>(out, d_o, delta, (size_t)B * H * T_len, stream);
  if (e != cudaSuccess) return e;
  Args<T> g;
  g.qu = static_cast<const T*>(qu);
  g.qv = static_cast<const T*>(qv);
  g.k = static_cast<const T*>(k);
  g.v = static_cast<const T*>(v);
  g.p = static_cast<const T*>(p);
  g.d_o = static_cast<const T*>(d_o);
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = static_cast<T*>(dqu);
  g.dqv = static_cast<T*>(dqv);
  g.dk = static_cast<T*>(dk);
  g.dv = static_cast<T*>(dv);
  g.dp = dp;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  auto q_pass = rel_bwd_query_pass_mma<T>;
  e = cudaFuncSetAttribute(q_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Pass<T>::kQSmem);
  if (e != cudaSuccess) return e;
  q_pass<<<grid, Pass<T>::kThreads, Pass<T>::kQSmem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto k_pass = rel_bwd_key_pass_mma<T>;
  e = cudaFuncSetAttribute(k_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Pass<T>::kKSmem);
  if (e != cudaSuccess) return e;
  k_pass<<<grid, Pass<T>::kThreads, Pass<T>::kKSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous. q_u, q_v, k, v, out, d_out and the gradients dq_u,
// dq_v, dk, dv: (B, H, T, dk) of the input type; p (H, 2T-1, dk); mask (B, T)
// uint8; lse (B, H, T) float32 from the forward. dp: float32 (H, 2T-1, dk),
// zeroed by the caller, receives the position table's gradient. delta:
// float32 (B, H, T) scratch. dtype: 0 = float32 (3xTF32), 1 = bfloat16;
// pointers 16-byte aligned. Only dk = 64.
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
    e = launch<float>(qu, qv, k, v, p, m, l, out, d_out, dqu, dqv, dk_out, dv_out, dpf, dl, B, H,
                      T_len, drop, s);
  else if (dtype == 1)
    e = launch<bf16>(qu, qv, k, v, p, m, l, out, d_out, dqu, dqv, dk_out, dv_out, dpf, dl, B, H,
                     T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
