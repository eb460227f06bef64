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
// What bounds it: eight (T x T x 64) products per (batch, head) plus the
// recomputation of S and dPr in the second pass, against O(T) bytes:
// operations. This first version runs them as FP32 FMAs, so the FP32
// CUDA-core rate is its ceiling.
//
// What the design does about it: the TPU kernel is one sequential program per
// (batch, head) that carries dK, dV and dP in fast memory across query blocks
// and un-shears dS with log2 rolls. Here two kernels run after a row-dot
// pre-pass (flash_bwd_tile.cuh): the query pass owns 64 query rows, loops
// over key tiles and keeps dQ_u and dQ_v in registers; the key pass owns 64
// keys, loops over query tiles and keeps dK and dV in registers. Nothing
// quadratic reaches device memory. The position terms need no inverse shear:
// with the tile's 127-row window of the table in shared memory
// (rel_tile.cuh), dQ_v is a product of dS with window rows read along the
// diagonal, and the tile's share of dP is a product of the diagonals of dS
// with Q_v, added to an f32 (H, 2T-1, 64) buffer with atomics, because every
// tile of a diagonal band and every batch row adds to the same table rows.
// The atomics make dP's summation order differ between runs (last-bit
// differences); everything else is deterministic. The dropout mask is
// philox.cuh's, a function of (seed, b*h, i, j), so both passes see the
// forward's mask. Bounds are checked: any T.

#include "flash_bwd_tile.cuh"
#include "rel_tile.cuh"

namespace {

using namespace flash;

// query pass: Q_u, Q_v, dO, K, V, dS tiles, the window, the mask flags
constexpr size_t kQPassSmem = ((size_t)(6 * kB + kWin) * kS + kB) * sizeof(float);
// key pass: K, V, Q_u, Q_v, dO, dS, P~ tiles, the window, the mask flags
constexpr size_t kKPassSmem = ((size_t)(7 * kB + kWin) * kS + kB) * sizeof(float);

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

template <typename T>
__global__ void __launch_bounds__(kThreads) rel_bwd_query_pass(const Args<T> g) {
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
  const T* ph = g.p + (size_t)h * (2 * T_len - 1) * kD;
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
  write_grad<T>(g.dqu + base, i0, T_len, ty, tx, dqu);
  write_grad<T>(g.dqv + base, i0, T_len, ty, tx, dqv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rel_bwd_key_pass(const Args<T> g) {
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
  const T* ph = g.p + (size_t)h * (2 * T_len - 1) * kD;
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
  write_grad<T>(g.dk + base, j0, T_len, ty, tx, dk);
  write_grad<T>(g.dv + base, j0, T_len, ty, tx, dv);
}

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   void* dqu, void* dqv, void* dk, void* dv, float* dp, float* delta, int B,
                   int H, int T_len, philox::Dropout drop, cudaStream_t stream) {
  cudaError_t e = launch_row_dot<T>(out, d_o, delta, (size_t)B * H * T_len, stream);
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
  auto q_pass = rel_bwd_query_pass<T>;
  e = cudaFuncSetAttribute(q_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kQPassSmem);
  if (e != cudaSuccess) return e;
  q_pass<<<grid, kThreads, kQPassSmem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto k_pass = rel_bwd_key_pass<T>;
  e = cudaFuncSetAttribute(k_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kKPassSmem);
  if (e != cudaSuccess) return e;
  k_pass<<<grid, kThreads, kKPassSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous. q_u, q_v, k, v, out, d_out and the gradients dq_u,
// dq_v, dk, dv: (B, H, T, dk) of the input type; p (H, 2T-1, dk); mask (B, T)
// uint8; lse (B, H, T) float32 from the forward. dp: float32 (H, 2T-1, dk),
// zeroed by the caller, receives the position table's gradient. delta:
// float32 (B, H, T) scratch. dtype: 0 = float32, 1 = bfloat16. Only dk = 64.
// rate and seed as given to the forward. Returns cudaGetLastError() after
// the launches.
extern "C" int l2s_rel_attention_bwd(const void* qu, const void* qv, const void* k,
                                     const void* v, const void* p, const void* mask,
                                     const void* lse, const void* out, const void* d_out,
                                     void* dqu, void* dqv, void* dk_out, void* dv_out, void* dp,
                                     void* delta, int B, int H, int T_len, int dk, int dtype,
                                     float rate, unsigned long long seed, void* stream) {
  if (dk != kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* dpf = static_cast<float*>(dp);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(qu, qv, k, v, p, m, l, out, d_out, dqu, dqv, dk_out, dv_out, dpf, dl, B,
                      H, T_len, drop, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(qu, qv, k, v, p, m, l, out, d_out, dqu, dqv, dk_out, dv_out, dpf,
                              dl, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
