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
// What bounds it: the f32 bias is read twice (once per pass) and dbias is
// written once, 12 T^2 bytes per (batch, head), against seven (T x T x 64)
// products: with tensor cores it would be bound by bytes. This first version
// runs the products as FP32 FMAs, which are its ceiling for now.
//
// What the design does about it: the TPU kernel carries dK and dV across
// query blocks in one sequential program and wants bias and dbias re-tiled
// to (key block, row, 128 lanes). Here the two passes of flash_bwd_tile.cuh
// run in parallel blocks, bias and dbias stay (T, T) rows, each half-warp
// reads and writes 64 consecutive floats of a row, and every (query, key)
// pair is written exactly once by the query pass, so dbias needs no zeroing
// and nothing past T is written. Everything is deterministic.

#include "flash_bwd_tile.cuh"

namespace {

using namespace flash;

// query pass: Q_u, dO, K, V, dS tiles and the mask flags
constexpr size_t kQPassSmem = ((size_t)5 * kB * kS + kB) * sizeof(float);
// key pass: K, V, Q_u, dO, dS, P~ tiles and the mask flags
constexpr size_t kKPassSmem = ((size_t)6 * kB * kS + kB) * sizeof(float);

template <typename T>
struct Args {
  const T *qu, *k, *v, *d_o;
  const float* bias;
  const uint8_t* mask;
  const float *lse, *delta;
  T *dqu, *dk, *dv;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) bias_bwd_query_pass(const Args<T> g) {
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
  write_grad<T>(g.dqu + base, i0, T_len, ty, tx, dqu);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bias_bwd_key_pass(const Args<T> g) {
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
  write_grad<T>(g.dk + base, j0, T_len, ty, tx, dk);
  write_grad<T>(g.dv + base, j0, T_len, ty, tx, dv);
}

template <typename T>
cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   void* dqu, void* dk, void* dv, float* dbias, float* delta, int B, int H,
                   int T_len, philox::Dropout drop, cudaStream_t stream) {
  cudaError_t e = launch_row_dot<T>(out, d_o, delta, (size_t)B * H * T_len, stream);
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
  g.dqu = static_cast<T*>(dqu);
  g.dk = static_cast<T*>(dk);
  g.dv = static_cast<T*>(dv);
  g.dbias = dbias;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  auto q_pass = bias_bwd_query_pass<T>;
  e = cudaFuncSetAttribute(q_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kQPassSmem);
  if (e != cudaSuccess) return e;
  q_pass<<<grid, kThreads, kQPassSmem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto k_pass = bias_bwd_key_pass<T>;
  e = cudaFuncSetAttribute(k_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kKPassSmem);
  if (e != cudaSuccess) return e;
  k_pass<<<grid, kThreads, kKPassSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous. q_u, k, v, out, d_out and the gradients dq_u, dk,
// dv: (B, H, T, dk) of the input type; bias and dbias (B, H, T, T) float32
// (dbias need not be zeroed); mask (B, T) uint8; lse (B, H, T) float32 from
// the forward; delta: float32 (B, H, T) scratch. dtype: 0 = float32,
// 1 = bfloat16. Only dk = 64. rate and seed as given to the forward. Returns
// cudaGetLastError() after the launches.
extern "C" int l2s_rel_attention_bias_bwd(const void* qu, const void* k, const void* v,
                                          const void* bias, const void* mask, const void* lse,
                                          const void* out, const void* d_out, void* dqu,
                                          void* dk_out, void* dv_out, void* dbias, void* delta,
                                          int B, int H, int T_len, int dk, int dtype,
                                          float rate, unsigned long long seed, void* stream) {
  if (dk != kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
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
    e = launch<float>(qu, k, v, bi, m, l, out, d_out, dqu, dk_out, dv_out, db, dl, B, H, T_len,
                      drop, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(qu, k, v, bi, m, l, out, d_out, dqu, dk_out, dv_out, db, dl, B,
                              H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
