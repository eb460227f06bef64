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
// O(T) bytes: operations, on the tensor cores (bf16; f32 in 3xTF32, three
// TF32 products for each f32 one).
//
// Design. The TPU kernel's whole-row score residency and its log2 roll shear
// were Mosaic workarounds and are gone. One block owns 64 query rows of one
// (batch, head), 4 warps of 16 rows, and loops over key tiles of 64 with an
// online softmax; nothing quadratic reaches device memory. A key tile's
// diagonals touch the 127 position-table rows p[T-1-(i0+63)+j0 ...] (the
// window), and BD[a, j] = q_v[a].window[63-a+j].
//
// One kernel for both input types, `rel_attention_mma<T>` (the same tile
// loop; the type picks the tiles, the products and the epilogue's stores).
//
// bf16 (dtype 1): every product on mma.sync m16n8k16 with f32 accumulation
// (mma_tile.cuh). Q_u and Q_v fragments stay in registers for the whole
// loop. K, V and the window arrive by cp.async into swizzled bf16 tiles,
// double-buffered: tile j+1 (and the window's next 64 rows; the window is a
// ring of three 64-row chunks) loads while tile j computes. Warp w's 16 rows
// touch only window rows 48-16w .. 127-16w, so the position term is G =
// Q_v,w . Win_w^T (16 x 80 x 64) on the tensor cores, stored f32 to a
// per-warp scratch and read back along the diagonal (BD[a, j] = G[a,
// 15-a+j]) into the score accumulator: 1.25 content products, no shear. The
// softmax runs on the accumulator fragments (quad shuffles), with the
// ex2-based __expf (P's bf16 rounding dominates its error); P is rounded to
// bf16 in registers and is the A operand of P V. Dropout maps the
// accumulator layout onto philox.cuh's counter: two lanes share each group
// of four keys and split one Philox call per row pair. 96.8 KB of shared
// memory: two blocks per SM.
//
// f32 (dtype 0): the same loop in 3xTF32 on mma.sync m16n8k8 (each operand
// split into a TF32 hi and an f32 lo = v - hi, three products each; about
// 2^-21 of |a b| dropped, so the f32 path is held to 1e-4 against the plain
// version, where one TF32 product, ~1e-3 off, would not pass). f32 tiles of
// 64 x 68 floats (mma_tile.cuh). Every operand is split after it is read,
// per warp; the kernel is bound by latency and issue (the split and three
// products for each f32 product), not by the tensor cores, so it keeps two
// blocks an SM: 107.3 KB of shared memory with one stage of K and of V (the
// other block hides the loads; the next K tile loads once this tile's
// scores are done) and Q_u and Q_v staged through the G scratch and the
// ring's third slot into registers, held unsplit (64 registers; split,
// 128). The position term's G is built in blocks of at most 48 window rows
// (24 accumulators). P stays in registers as the A of P V: the k8 step
// takes its keys in the order 0, 2, 4, 6, 1, 3, 5, 7, which is where the
// m16n8 accumulator holds them, and V's rows are read in that order by
// single floats (conflict-free at the stride of 68).
//
// Bounds are checked, so T need not be a multiple of 64.

#include "mma_tile.cuh"

namespace {

using namespace mma;

template <typename T>
struct Fwd {
  // bf16: K and V double-buffered, Q_u and Q_v in tiles of their own; f32:
  // one stage of K and of V, Q_u and Q_v staged through the G scratch and
  // the window ring's third slot (so that two blocks fit an SM)
  static constexpr int kStages = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kQTiles = sizeof(T) == 2 ? 2 : 0;
  // Q tiles, K and V stages, the window ring, the warps' G scratch, the mask flags
  static constexpr size_t kSmem =
      (size_t)(kQTiles + 2 * kStages + 3) * Tile<T>::kElems * sizeof(T) +
      ((size_t)kWarps * 16 * kGld + kStages * kB) * sizeof(float);
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_mma(const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ p,
                  const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
                  int H, int T_len, float scale, philox::Dropout drop) {
  constexpr int E = Tile<T>::kElems, kStages = Fwd<T>::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw) + Fwd<T>::kQTiles * E;   // kStages stages
  T* sV = sK + kStages * E;                                        // kStages stages
  const Ring<T> win{sV + kStages * E};
  float* sG = reinterpret_cast<float*>(win.s + 3 * E);
  float* sM = sG + kWarps * 16 * kGld;                             // kStages stages
  T* sQu = kStages == 2 ? reinterpret_cast<T*>(smem_raw) : reinterpret_cast<T*>(sG);
  T* sQv = kStages == 2 ? sQu + E : win.chunk(2);

  const int bh = blockIdx.y, h = bh % H, i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const int n_table = 2 * T_len - 1;
  const T* ph = p + (size_t)h * n_table * kD;
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

  RowsA<T> aqu, aqv;
  if (kStages == 1) {   // Q into registers before the G scratch and chunk 2 are written
    cp_async_wait<0>();
    __syncthreads();
    aqu.init(sQu, 16 * warp, lane);
    aqv.init(sQv, 16 * warp, lane);
    __syncthreads();
  }
  float o[8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = kStages == 2 ? t & 1 : 0;
    if (kStages == 1) {
      cp_async_wait<0>();          // tile t's K, V, mask and window chunk t + 1
    } else if (t + 1 < n_tiles) {  // stage t+1 was last read in tile t-1
      const int j1 = (t + 1) * kB;
      load_tile(sK + (st ^ 1) * E, k + base, j1, T_len);
      load_tile(sV + (st ^ 1) * E, v + base, j1, T_len);
      load_tile(win.chunk(t + 2), ph, p_base + (t + 2) * kB, n_table);
      flash::load_mask(sM + (st ^ 1) * kB, mask_row, j1, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kStages == 2 && t == 0) {
      aqu.init(sQu, 16 * warp, lane);
      aqv.init(sQv, 16 * warp, lane);
    }
    const T* kt = sK + st * E;
    const T* vt = sV + st * E;
    const float* mt = sM + st * kB;

    float s[8][4];
    zero(s);
    product_nt(s, aqu, kt, lane);
    add_position_term(s, aqv, win, t, 48 - 16 * warp, lane, G);
    if (kStages == 1) {
      __syncthreads();   // K and window chunk t are consumed
      if (t + 1 < n_tiles) {
        load_tile(sK, k + base, (t + 1) * kB, T_len);
        load_tile(win.chunk(t + 2), ph, p_base + (t + 2) * kB, n_table);
        cp_async_commit();
      }
    }

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
    product_acc_nn(o, s, vt, lane);
    __syncthreads();   // stage st and window chunk t are consumed
    if (kStages == 1 && t + 1 < n_tiles) {   // tile t+1's V and mask
      load_tile(sV, v + base, (t + 1) * kB, T_len);
      flash::load_mask(sM, mask_row, (t + 1) * kB, T_len);
      cp_async_commit();
    }
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

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                   const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                   philox::Dropout drop, cudaStream_t stream) {
  if (!aligned16({qu, qv, k, v, p, out})) return cudaErrorMisalignedAddress;
  auto kern = rel_attention_mma<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Fwd<T>::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, Fwd<T>::kSmem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), mask, static_cast<T*>(out), lse, H,
      T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q_u, q_v, k, v, out (B, H, T, dk); p (H, 2T-1, dk);
// mask (B, T) uint8; lse (B, H, T) float32. dtype: 0 = float32 (3xTF32), 1 =
// bfloat16; pointers 16-byte aligned. Only dk = 64.
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
    e = launch<float>(qu, qv, k, v, p, m, out, l, B, H, T_len, drop, s);
  else if (dtype == 1)
    e = launch<bf16>(qu, qv, k, v, p, m, out, l, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
