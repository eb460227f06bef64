// Transformer-XL relative-position flash attention, forward, for Hopper
// (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_rel_attention.py, `_kernel` (entry
// `rel_flash_attention` -> `_rel_flash_impl`).
//
// Computes, per (batch, head), with q_u, q_v, k, v (T, 64), p (2T-1, 64):
//     S[i, j] = (q_u[i].k[j] + q_v[i].p[T-1-i+j]) / sqrt(64)
// keys with mask 0 score -1e30, then O = softmax_j(S) V and the per-row
// log-sum-exp. Rows whose keys are all masked stay finite (a uniform average
// of V over the sequence); callers slice them off. With dropout (`_keep_mask`
// in the TPU kernel) the product with V sees the probabilities times
// keep / (1 - rate), while the softmax sum and the log-sum-exp come from the
// undropped ones; the mask is philox.cuh's, a function of (seed, b*h, i, j),
// so rel_attention_bwd.cu replays it whatever its tiling.
//
// What bounds it: three (T x T x 64) products per (batch, head) against
// O(T) bytes: operations, on the bf16 tensor cores.
//
// Design. The TPU kernel's whole-row score residency and its log2 roll shear
// were Mosaic workarounds and are gone. One block owns 64 query rows of one
// (batch, head), 4 warps of 16 rows, and loops over key tiles of 64 with an
// online softmax; nothing quadratic reaches device memory. A key tile's
// diagonals touch the 127 position-table rows p[T-1-(i0+63)+j0 ...] (the
// window), and BD[a, j] = q_v[a].window[63-a+j].
//
// bf16 (dtype 1), `rel_attention_mma`: every product on mma.sync m16n8k16
// with f32 accumulation (mma_tile.cuh). Q_u and Q_v fragments stay in
// registers for the whole loop. K, V and the window arrive by cp.async into
// swizzled bf16 tiles, double-buffered: tile j+1 (and the window's next 64
// rows; the window is a ring of three 64-row chunks) loads while tile j
// computes. Warp w's 16 rows touch only window rows 48-16w .. 127-16w, so
// the position term is G = Q_v,w . Win_w^T (16 x 80 x 64) on the tensor
// cores, stored f32 to a per-warp scratch and read back along the diagonal
// (BD[a, j] = G[a, 15-a+j]) into the score accumulator: 1.25 content
// products, no shear. The softmax runs on the accumulator fragments (quad
// shuffles), with the ex2-based __expf (P's bf16 rounding dominates its
// error); P is rounded to bf16 in registers and is the A operand of P V.
// Dropout maps the accumulator layout onto philox.cuh's counter: two lanes
// share each group of four keys and split one Philox call per row pair.
// 96.8 KB of shared memory: two blocks per SM.
//
// f32 (dtype 0), `rel_attention_kernel`: the first version, kept unchanged on
// the CUDA cores (FP32 FMAs, f32 shared tiles, rel_tile.cuh), because the
// f32 path is held to 1e-4 against the CPU and TF32 cannot meet that.
//
// Bounds are checked, so T need not be a multiple of 64.

#include "mma_tile.cuh"
#include "rel_tile.cuh"

namespace {

namespace mma_path {

using namespace mma;

// Q_u, Q_v, two stages of K and of V, the window ring, the warps' G
// scratch, two stages of mask flags
constexpr size_t kSmem = (size_t)9 * kTile * sizeof(bf16) +
                         ((size_t)kWarps * 16 * kGld + 2 * kB) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
rel_attention_mma(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
                  const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ p, const uint8_t* __restrict__ mask,
                  bf16* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                  float scale, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQu = reinterpret_cast<bf16*>(smem_raw);
  bf16* sQv = sQu + kTile;
  bf16* sK = sQv + kTile;        // two stages
  bf16* sV = sK + 2 * kTile;     // two stages
  const Ring win{sV + 2 * kTile};
  float* sG = reinterpret_cast<float*>(win.s + 3 * kTile);
  float* sM = sG + kWarps * 16 * kGld;   // two stages

  const int bh = blockIdx.y, h = bh % H, i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const int n_table = 2 * T_len - 1;
  const bf16* ph = p + (size_t)h * n_table * kD;
  const int p_base = T_len - 1 - (i0 + kB - 1);   // table row of window chunk 0
  const uint8_t* mask_row = mask + (size_t)(bh / H) * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int i_g = i0 + 16 * warp + (lane >> 2);   // the lane's first row
  float* G = sG + warp * 16 * kGld;
  const int n_tiles = (T_len + kB - 1) / kB;

  load_tile(sQu, qu + base, i0, T_len);
  load_tile(sQv, qv + base, i0, T_len);
  load_tile(sK, k + base, 0, T_len);
  load_tile(sV, v + base, 0, T_len);
  load_tile(win.chunk(0), ph, p_base, n_table);
  load_tile(win.chunk(1), ph, p_base + kB, n_table);
  flash::load_mask(sM, mask_row, 0, T_len);
  cp_async_commit();

  uint32_t aqu[4][4], aqv[4][4];
  float o[8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {       // stage t+1 was last read in tile t-1
      const int j1 = (t + 1) * kB;
      load_tile(sK + (st ^ 1) * kTile, k + base, j1, T_len);
      load_tile(sV + (st ^ 1) * kTile, v + base, j1, T_len);
      load_tile(win.chunk(t + 2), ph, p_base + (t + 2) * kB, n_table);
      flash::load_mask(sM + (st ^ 1) * kB, mask_row, j1, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_a(aqu, sQu, 16 * warp, lane);
      load_a(aqv, sQv, 16 * warp, lane);
    }
    const bf16* kt = sK + st * kTile;
    const bf16* vt = sV + st * kTile;
    const float* mt = sM + st * kB;

    float s[8][4];
    zero(s);
    product_nt(s, aqu, kt, lane);
    add_position_term(s, aqv, win, t, warp, lane, G);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = flash::mask_score(s[n][e] * scale, mt[8 * n + 2 * q + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);   // finite: key 0 lies in the sequence
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m_run[e >> 1]);
        rs[e >> 1] += s[n][e];
        o[n][e] *= alpha[e >> 1];
      }
    // the lane's share of the row sums; the quad adds them up at the end
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
    if (drop.thresh != 0u) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float kf[4];
        keep_frag(drop, (uint32_t)bh, i_g, t * kB + 8 * n + 2 * q, q, kf);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= kf[e];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      to_a(a, s, kk);
      product_nn_step(o, a, vt, kk, lane);
    }
    __syncthreads();   // stage st and window chunk t are consumed
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-20f);
    inv[r] = 1.f / l;
    const int i = i_g + 8 * r;
    if (q == 0 && i < T_len) lse[(size_t)bh * T_len + i] = m_run[r] + logf(l);
  }
  store_rows(out + base, o, i_g, T_len, inv, q);
}

cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                   const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                   philox::Dropout drop, cudaStream_t stream) {
  if (!aligned16({qu, qv, k, v, p, out})) return cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(rel_attention_mma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  rel_attention_mma<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(qu), static_cast<const bf16*>(qv), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(p), mask, static_cast<bf16*>(out),
      lse, H, T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

}  // namespace mma_path

namespace fma_path {

using namespace flash;

// Q_u, Q_v, K (then the probabilities), V tiles, the window, the mask flags
constexpr size_t kRelSmemBytes = ((size_t)(4 * kB + kWin) * kS + kB) * sizeof(float);

// One block of 256 threads owns 64 query rows; thread (ty, tx) owns a 4x4
// score tile whose 16 diagonals need only 7 window rows. Shared tiles are f32
// with a padded stride (65); all arithmetic is f32 FMAs (flash_tile.cuh,
// rel_tile.cuh).
__global__ void __launch_bounds__(kThreads)
rel_attention_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ p, const uint8_t* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                     float scale, philox::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQu = reinterpret_cast<float*>(smem_raw);
  float* sQv = sQu + kB * kS;
  float* sK = sQv + kB * kS;     // key tile, then that tile's probabilities
  float* sV = sK + kB * kS;
  float* sP = sV + kB * kS;      // position-table window
  float* sM = sP + kWin * kS;    // 1 valid, 0 masked, -1 past the sequence

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* ph = p + (size_t)h * (2 * T_len - 1) * kD;
  const uint8_t* mask_row = mask + (size_t)(bh / H) * T_len;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sQu, qu + base, i0, T_len);
  load_tile(sQv, qv + base, i0, T_len);
  State st;
  st.init();

  for (int j0 = 0; j0 < T_len; j0 += kB) {
    __syncthreads();  // the previous tile's probabilities and V are consumed
    load_tile(sK, k + base, j0, T_len);
    load_tile(sV, v + base, j0, T_len);
    load_window(sP, ph, window_start(T_len, i0, j0), T_len);
    load_mask(sM, mask_row, j0, T_len);
    __syncthreads();

    float s[4][4];
    rel_scores(sQu, sQv, sK, sP, ty, tx, scale, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = mask_score(s[a][j], sM[4 * tx + j]);
    softmax_step(s, st);
    pv_product_dropout(sK, sV, ty, tx, s, st, drop, bh, i0, j0);
  }
  write_out(out + base, lse + (size_t)bh * T_len, i0, T_len, ty, tx, st);
}

cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v,
                   const void* p, const uint8_t* mask, void* out, float* lse, int B, int H,
                   int T_len, philox::Dropout drop, cudaStream_t stream) {
  auto kern = rel_attention_kernel;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kRelSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kRelSmemBytes, stream>>>(
      static_cast<const float*>(qu), static_cast<const float*>(qv), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(p), mask, static_cast<float*>(out),
      lse, H, T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

}  // namespace fma_path

}  // namespace

// All tensors contiguous: q_u, q_v, k, v, out (B, H, T, dk); p (H, 2T-1, dk);
// mask (B, T) uint8; lse (B, H, T) float32. dtype: 0 = float32 (FMA kernel),
// 1 = bfloat16 (tensor-core kernel; pointers 16-byte aligned). Only dk = 64.
// rate in [0, 1) and seed select the dropout mask (rate 0: no dropout).
// Returns cudaGetLastError() after the launch.
extern "C" int l2s_rel_attention(const void* qu, const void* qv, const void* k,
                                 const void* v, const void* p, const void* mask, void* out,
                                 void* lse, int B, int H, int T_len, int dk, int dtype,
                                 float rate, unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  cudaError_t e;
  if (dtype == 0)
    e = fma_path::launch(qu, qv, k, v, p, m, out, l, B, H, T_len, drop, s);
  else if (dtype == 1)
    e = mma_path::launch(qu, qv, k, v, p, m, out, l, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
