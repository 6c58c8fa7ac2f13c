// Flash attention's backward pass for Hopper: dQ, dK and dV of the forward
// in csrc/flash_attention.cu (causal and/or sliding-window online-softmax
// attention with grouped KV heads and a key count), f32 or bf16 in, the
// gradients in the input's type.
//
// Replaces no Pallas kernel: src/repro/kernels/flash_attention.py
// (flash_attention_pallas, line 107) has no backward, because JAX trains by
// differentiating jnp.  The port runs prefill attention on the forward
// kernel, so training on the card needs this one.  kernels/flash_attention.py
// (flash_attention_bwd_cuda) launches it and flash_attention_bwd_plain is its
// plain version, step for step.
//
// The forward writes no log-sum-exp, so three kernels run in one launcher
// call, each block 256 threads over 64-row blocks of queries or keys:
//   1. fa_bwd_prep, a block per (64 query rows, q head): Delta = rowsum(dO o O)
//      and each row's softmax statistics over the forward's key tiles, m (the
//      running max, starting at NEG_INF = -1e30) and 1 / l (l the sum of
//      exp(s - m)), with the forward's masking: masked logits are NEG_INF,
//      not -inf, so a row whose every key is masked gets the forward's
//      uniform weights over the tiles it visits.
//   2. fa_bwd_dkdv, a block per (64 key rows, kv head): for each q head of the
//      kv head's group and each query block whose tiles hold the key block
//      (the inverse of kv_range, found by walking the query blocks), it
//      recomputes P = exp(scale Q K^T - m) / l, then dV += P^T dO,
//      dP = dO V^T, dS = P o (dP - Delta) (0 where masked), dK += dS^T Q;
//      dK is scaled once at the end.
//   3. fa_bwd_dq, a block per (64 query rows, q head): dQ = scale sum dS K over
//      the row block's key tiles.
// No atomics: a kv head's group is summed in a fixed order (q heads, then
// query blocks, ascending), so a run gives the same bits every time.
//
// The key tiles a query block visits are the forward's: kv_range in units
// of the reference's bk = 128 for the 128-row query block that holds it
// (FA_BQ), then cut to the key count kv_len.  Every 64 x 64 pair inside
// those tiles is computed, none skipped, so the uniform rows above match the
// forward exactly.
//
// Bound: operations.  The function's work is five products of the query
// block by key block pairs the mask keeps (Q K^T, dP = dO V^T, dV, dK, dQ);
// this design runs eight (Q K^T in each of the three kernels, dO V^T in the
// last two), all as f32 FFMA from shared memory: bf16 inputs are widened to
// f32 as they are loaded (each product of two bf16 values is exact in f32).
// It is the simple design: wgmma, TMA and a shared pass for dQ belong to a
// later redesign.  Each thread owns a 4 x 4 tile of a 64 x 64 logit block
// (rows 4 ty .. 4 ty + 3, columns tx + 16 j), read as float4 runs of d from
// rows padded by 4 floats (no bank conflicts), and a 4 x D / 16 tile of the
// 64 x D sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa_bwd {

constexpr int kBlk = 64;        // rows of a query block and of a key block
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kBq = 128;        // the forward's query block and key tile (bq = bk)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A 64 x D tile's row pitch in floats, and a 64 x 64 block's
template <int D>
struct Shape {
  static constexpr int kPitch = D + 4;
  static constexpr int kTile = kBlk * kPitch;
  static constexpr int kCols = D / 64;   // 64-column groups a thread's sums span
};
constexpr int kSPitch = kBlk + 4;
constexpr int kSTile = kBlk * kSPitch;

// The forward's [lo, hi) key tiles of 128 rows for the 128-row query block
// at row q0 (kernels/flash_attention.py kv_range with bq = bk = 128).  A
// negative (q0 - window + 1) / 128 truncates where Python floors; both clamp
// to 0.
__device__ __forceinline__ void kv_tiles(int q0, int s, int causal, int window, int kv_len,
                                         int* lo, int* hi) {
  int h = causal ? min((q0 + 2 * kBq - 1) / kBq, s / kBq) : s / kBq;
  const int l = window > 0 ? max((q0 - window + 1) / kBq, 0) : 0;
  h = max(min(h, (kv_len + kBq - 1) / kBq), l);
  *lo = l;
  *hi = h;
}

__device__ __forceinline__ bool visible(int qi, int kj, int causal, int window, int kv_len) {
  return (!causal || kj <= qi) && (window <= 0 || kj > qi - window) && kj < kv_len;
}

// rows [0, 64) of a (rows, D) matrix of T at src -> f32 tile at dst
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src) {
  for (int i = threadIdx.x; i < kBlk * D; i += kThreads)
    dst[(i / D) * Shape<D>::kPitch + i % D] = to_f(src[i]);
}

// acc[i][j] = sum_d a[4 ty + i][d] b[tx + 16 j][d]: two 64 x D tiles
template <int D>
__device__ __forceinline__ void product_abt(const float* a, const float* b, float acc[4][4],
                                            int ty, int tx) {
  constexpr int P = Shape<D>::kPitch;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * P + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        acc[i][j] = x;
      }
  }
}

// acc[i][c][e] += sum_r a[r][4 ty + i] b[r][64 c + 4 tx + e]: a a 64 x 64
// block (pitch kSPitch), b a 64 x D tile
template <int D>
__device__ __forceinline__ void product_atb(const float* a, const float* b,
                                            float acc[4][Shape<D>::kCols][4], int ty, int tx) {
  constexpr int P = Shape<D>::kPitch;
#pragma unroll 4
  for (int r = 0; r < kBlk; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(a + r * kSPitch + 4 * ty);
    const float ai[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int c = 0; c < Shape<D>::kCols; ++c) {
      const float4 bv = *reinterpret_cast<const float4*>(b + r * P + 64 * c + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][c][0] = fmaf(ai[i], bv.x, acc[i][c][0]);
        acc[i][c][1] = fmaf(ai[i], bv.y, acc[i][c][1]);
        acc[i][c][2] = fmaf(ai[i], bv.z, acc[i][c][2]);
        acc[i][c][3] = fmaf(ai[i], bv.w, acc[i][c][3]);
      }
    }
  }
}

// The 16 threads of a half warp share a row: reductions over them
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The row statistics: stats[0] = m, stats[1] = 1 / l, stats[2] = Delta, each
// (bh, s) f32
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_prep(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ o,
                const float* __restrict__ dout, float* __restrict__ stats, int bh_total, int h,
                int kvh, int s, int kv_len, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + Shape<D>::kTile;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kv = (bh / h) * kvh + (bh % h) / (h / kvh);
  const size_t plane = static_cast<size_t>(bh_total) * s;
  float* m_out = stats;
  float* rl_out = stats + plane;
  float* delta_out = stats + 2 * plane;
  // Delta: a warp a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBlk; r += kThreads / 32) {
    const size_t row = static_cast<size_t>(bh) * s + q0 + r;
    float acc = 0.0f;
    for (int c = lane; c < D; c += 32) acc = fmaf(o[row * D + c], dout[row * D + c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta_out[row] = acc;
  }
  load_tile<T, D>(q_s, q + (static_cast<size_t>(bh) * s + q0) * D);
  int lo, hi;
  kv_tiles(q0 - q0 % kBq, s, causal, window, kv_len, &lo, &hi);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  for (int kb = 2 * lo; kb < 2 * hi; ++kb) {
    __syncthreads();   // the last block's reads of k_s are done (and q_s is loaded)
    load_tile<T, D>(k_s, k + (static_cast<size_t>(kv) * s + kb * kBlk) * D);
    __syncthreads();
    float acc[4][4];
    product_abt<D>(q_s, k_s, acc, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = visible(qi, kb * kBlk + tx + 16 * j, causal, window, kv_len)
                            ? acc[i][j] * scale
                            : kNegInf;
        acc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(acc[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + half_sum(sum);
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t row = static_cast<size_t>(bh) * s + q0 + 4 * ty + i;
      m_out[row] = m[i];
      rl_out[row] = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
    }
  }
}

// P and dS of one 64 x 64 block from Q K^T (sacc) and dO V^T (pacc); rows
// 4 ty + i are queries q0 + ..., columns tx + 16 j keys k0 + ...
__device__ __forceinline__ void softmax_grad(float sacc[4][4], float pacc[4][4],
                                             const float* stat_s, int q0, int k0, int ty,
                                             int tx, int causal, int window, int kv_len,
                                             float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const float m = stat_s[r], rl = stat_s[kBlk + r], delta = stat_s[2 * kBlk + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool keep = visible(q0 + r, k0 + tx + 16 * j, causal, window, kv_len);
      const float p = expf((keep ? sacc[i][j] * scale : kNegInf) - m) * rl;
      sacc[i][j] = p;
      pacc[i][j] = keep ? p * (pacc[i][j] - delta) : 0.0f;
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_rows(float* q_s, float* do_s, float* stat_s, const T* q,
                                          const float* dout, const float* stats, size_t plane,
                                          int bh, int s, int q0) {
  const size_t row0 = static_cast<size_t>(bh) * s + q0;
  load_tile<T, D>(q_s, q + row0 * D);
  load_tile<float, D>(do_s, dout + row0 * D);
  if (threadIdx.x < 3 * kBlk) {
    const int which = threadIdx.x / kBlk, r = threadIdx.x % kBlk;
    stat_s[threadIdx.x] = stats[which * plane + row0 + r];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ stats,
                T* __restrict__ dk, T* __restrict__ dv, int bh_total, int h, int kvh, int s,
                int kv_len, int causal, int window, float scale) {
  constexpr int C = Shape<D>::kCols;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + Shape<D>::kTile;
  float* q_s = v_s + Shape<D>::kTile;
  float* do_s = q_s + Shape<D>::kTile;
  float* p_s = do_s + Shape<D>::kTile;
  float* ds_s = p_s + kSTile;
  float* stat_s = ds_s + kSTile;
  const int kvi = blockIdx.y, k0 = blockIdx.x * kBlk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = kvi / kvh, g = kvi % kvh, group = h / kvh;
  const size_t plane = static_cast<size_t>(bh_total) * s;
  const size_t krow0 = static_cast<size_t>(kvi) * s + k0;
  load_tile<T, D>(k_s, k + krow0 * D);
  load_tile<T, D>(v_s, v + krow0 * D);
  float dk_acc[4][C][4], dv_acc[4][C][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][c][e] = dv_acc[i][c][e] = 0.0f;
  const int tile = k0 / kBq;
  for (int hq = g * group; hq < (g + 1) * group; ++hq) {
    const int bh = b * h + hq;
    for (int qb = 0; qb < s / kBq; ++qb) {
      int lo, hi;
      kv_tiles(qb * kBq, s, causal, window, kv_len, &lo, &hi);
      if (tile < lo || tile >= hi) continue;
      for (int half = 0; half < 2; ++half) {
        const int q0 = qb * kBq + half * kBlk;
        __syncthreads();   // the last pair's reads of q_s, do_s, p_s, ds_s are done
        load_rows<T, D>(q_s, do_s, stat_s, q, dout, stats, plane, bh, s, q0);
        __syncthreads();
        float sacc[4][4], pacc[4][4];
        product_abt<D>(q_s, k_s, sacc, ty, tx);
        product_abt<D>(do_s, v_s, pacc, ty, tx);
        softmax_grad(sacc, pacc, stat_s, q0, k0, ty, tx, causal, window, kv_len, scale);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p_s[(4 * ty + i) * kSPitch + tx + 16 * j] = sacc[i][j];
            ds_s[(4 * ty + i) * kSPitch + tx + 16 * j] = pacc[i][j];
          }
        __syncthreads();
        product_atb<D>(p_s, do_s, dv_acc, ty, tx);    // dV += P^T dO
        product_atb<D>(ds_s, q_s, dk_acc, ty, tx);    // dK += dS^T Q
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = krow0 + 4 * ty + i;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t at = row * D + 64 * c + 4 * tx + e;
        dk[at] = from_f<T>(dk_acc[i][c][e] * scale);
        dv[at] = from_f<T>(dv_acc[i][c][e]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ stats,
              T* __restrict__ dq, int bh_total, int h, int kvh, int s, int kv_len, int causal,
              int window, float scale) {
  constexpr int C = Shape<D>::kCols;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + Shape<D>::kTile;
  float* k_s = do_s + Shape<D>::kTile;
  float* v_s = k_s + Shape<D>::kTile;
  float* dst_s = v_s + Shape<D>::kTile;   // dS transposed: [key][query]
  float* stat_s = dst_s + kSTile;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kv = (bh / h) * kvh + (bh % h) / (h / kvh);
  const size_t plane = static_cast<size_t>(bh_total) * s;
  load_rows<T, D>(q_s, do_s, stat_s, q, dout, stats, plane, bh, s, q0);
  float dq_acc[4][C][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[i][c][e] = 0.0f;
  int lo, hi;
  kv_tiles(q0 - q0 % kBq, s, causal, window, kv_len, &lo, &hi);
  for (int kb = 2 * lo; kb < 2 * hi; ++kb) {
    __syncthreads();   // the last block's reads of k_s, v_s, dst_s are done
    const size_t krow0 = static_cast<size_t>(kv) * s + kb * kBlk;
    load_tile<T, D>(k_s, k + krow0 * D);
    load_tile<T, D>(v_s, v + krow0 * D);
    __syncthreads();
    float sacc[4][4], pacc[4][4];
    product_abt<D>(q_s, k_s, sacc, ty, tx);
    product_abt<D>(do_s, v_s, pacc, ty, tx);
    softmax_grad(sacc, pacc, stat_s, q0, kb * kBlk, ty, tx, causal, window, kv_len, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst_s[(tx + 16 * j) * kSPitch + 4 * ty + i] = pacc[i][j];
    __syncthreads();
    product_atb<D>(dst_s, k_s, dq_acc, ty, tx);   // dQ += dS K
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = static_cast<size_t>(bh) * s + q0 + 4 * ty + i;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[row * D + 64 * c + 4 * tx + e] = from_f<T>(dq_acc[i][c][e] * scale);
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int bh, int h, int kvh, int s,
           int kv_len, int causal, int window, float scale, cudaStream_t st) {
  constexpr int tile = Shape<D>::kTile * 4;
  constexpr int prep_smem = 2 * tile;
  constexpr int dkdv_smem = 4 * tile + 2 * kSTile * 4 + 3 * kBlk * 4;
  constexpr int dq_smem = 4 * tile + kSTile * 4 + 3 * kBlk * 4;
  cudaError_t e;
  if ((e = opt_in(fa_bwd_prep<T, D>, prep_smem)) != cudaSuccess) return e;
  if ((e = opt_in(fa_bwd_dkdv<T, D>, dkdv_smem)) != cudaSuccess) return e;
  if ((e = opt_in(fa_bwd_dq<T, D>, dq_smem)) != cudaSuccess) return e;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  const float *of = static_cast<const float*>(o), *dof = static_cast<const float*>(dout);
  float* sf = static_cast<float*>(stats);
  fa_bwd_prep<T, D><<<dim3(s / kBlk, bh), kThreads, prep_smem, st>>>(
      qt, kt, of, dof, sf, bh, h, kvh, s, kv_len, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dkdv<T, D><<<dim3(s / kBlk, bh / h * kvh), kThreads, dkdv_smem, st>>>(
      qt, kt, vt, dof, sf, static_cast<T*>(dk), static_cast<T*>(dv), bh, h, kvh, s, kv_len,
      causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dq<T, D><<<dim3(s / kBlk, bh), kThreads, dq_smem, st>>>(
      qt, kt, vt, dof, sf, static_cast<T*>(dq), bh, h, kvh, s, kv_len, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace fa_bwd

// dq (bh, s, d), dk and dv (bh / h * kvh, s, d) of the attention of q (bh, s,
// d) over k, v (bh / h * kvh, s, d), all f32 (bf16 = 0) or all bf16 (bf16 =
// 1), given the forward's output o and its gradient dout (both (bh, s, d)
// f32); stats is f32 scratch of 3 x bh x s.  bh = B * h flattened q heads,
// h % kvh == 0, s % 128 == 0, d in {64, 128}; causal, window (> 0: a sliding
// window) and the key count kv_len (1 <= kv_len <= s) mask as the forward.
// Three launches on `stream`, no synchronisation; returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(int device, int bf16, const void* q, const void* k,
                                          const void* v, const void* o, const void* dout,
                                          void* dq, void* dk, void* dv, void* stats, int bh,
                                          int h, int kvh, int s, int kv_len, int d, int causal,
                                          int window, float scale, void* stream) {
  if (bh < 1 || h < 1 || kvh < 1 || h % kvh || bh % h || s < fa_bwd::kBq ||
      s % fa_bwd::kBq || kv_len < 1 || kv_len > s ||
      static_cast<long long>(bh) * s * d >= (1LL << 31) || s / fa_bwd::kBlk > 65535 ||
      bh > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return bf16 ? fa_bwd::launch<__nv_bfloat16, 64>(q, k, v, o, dout, dq, dk, dv, stats, bh, h,
                                                    kvh, s, kv_len, causal, window, scale, st)
                : fa_bwd::launch<float, 64>(q, k, v, o, dout, dq, dk, dv, stats, bh, h, kvh, s,
                                            kv_len, causal, window, scale, st);
  if (d == 128)
    return bf16 ? fa_bwd::launch<__nv_bfloat16, 128>(q, k, v, o, dout, dq, dk, dv, stats, bh,
                                                     h, kvh, s, kv_len, causal, window, scale,
                                                     st)
                : fa_bwd::launch<float, 128>(q, k, v, o, dout, dq, dk, dv, stats, bh, h, kvh, s,
                                             kv_len, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

// Each source builds into its own library, so each carries this once.
extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
