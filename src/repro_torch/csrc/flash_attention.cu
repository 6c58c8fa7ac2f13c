// Flash attention for Hopper: causal and/or sliding-window online-softmax
// attention with grouped KV heads, f32 in and out, f32 math.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_pallas
// (line 107) and its body _flash_kernel (line 27), with the batch dims that
// ops.py vmaps (line 255) folded into the grid: block (x, y) is q head x of
// the (B * H) flattened heads and q block y of FA_BQ = 128 rows; it reads KV
// head (x / H) * KVH + (x % H) / (H / KVH).  The KV range is pruned exactly
// as there, in units of the reference's bk:
//   hi = min(ceil((q0 + 128) / bk), S / bk) if causal, else S / bk
//   lo = max((q0 - window + 1) // bk, 0)    if window > 0, else 0
// and rows lo * bk .. hi * bk stream through the strategy's ring as two
// Operands (K and V), kc rows a ring slot: on the card bk is cut into kc-row
// sub-tiles so that a ring of depth 4 fits a block's shared memory (one K+V
// slot at bk = 128, D = 128 is 128 KB).  The blocks of the last q blocks
// have the longest KV ranges; blockIdx.y runs from the last q block down,
// so they start first.
//
// Bound: operations.  At the h100/flash_attention shape (b, h, kvh, s, d) =
// (4, 12, 2, 4096, 128), causal, the two products are 206.2 GFLOP against
// 235 MB of q, k, v and out: 3.08 ms at the 66.9 TFLOP/s f32 rate, 0.070 ms
// at the HBM rate.  The reference's 2e-5 f32 tolerance rules out TF32 and
// bf16 tensor cores, so both products are FFMA; the ring keeps K/V loads
// (L2 hits after the first q block of a head) off the FMA path.  The row
// max, the denominator and the (128 x D) accumulator stay in registers for
// the whole KV range, as the reference keeps them in VMEM scratch.
//
// Numerics are the reference's: q is scaled in f32 before the product,
// masked logits are NEG_INF = -1e30 (not -inf), the running max starts at
// NEG_INF and the denominator at 0, and the output is acc / max(l, 1e-30).
//
// Shared memory: run_pipeline's [ring][TMA mbarriers] (no out ring: the
// launcher declares kTileOutput = false), then at the next 16 bytes the
// block's scaled q tile (128 rows), then, except for DROP_OFF, the
// probabilities of one sub-tile (128 x kc).  Every K, V and q row pitch is
// its bytes + 16, so rows read by neighbouring threads fall in different
// banks.  Every strategy has a barrier (B1, or B0 for DROP_OFF) before its
// first compute, which orders the q tile's stores before the reads.
//
// Threads, every strategy but DROP_OFF (kc = 32): thread t owns q rows
// ty + 16 i (i < 8, ty = t / 16), the sub-tile's kv columns tx and tx + 16
// of the logits (tx = t % 16), and d columns 64 j + 4 tx .. +3 (j < D / 64)
// of the accumulator.  A row's 32 logits lie in the 16 lanes of one
// half-warp, which reduce its max and sum with 4 shuffles each; its
// probabilities go through the warp's rows of the shared P tile (a
// __syncwarp) to the P V product.
// DROP_OFF (kc = 4) holds its share of a slot in registers: the same rows
// and d columns, and K and V of all 4 kv rows at its d columns (64 floats
// at D = 128).  Each logit is then a partial dot over the thread's d
// columns, summed across the half-warp's 16 lanes by shuffles, so every
// lane of a row holds all 4 of its logits; reads cross threads' copies
// (kCrossThreadReads, barrier B0).
//
// Barriers per sub-tile (see async_pipeline.cuh for the loop; O = 0):
//   SYNC            ld.global/st.shared staging, B1, Q K^T, softmax, P V, B2
//   REGISTER_BYPASS cp.async, wait_group 0, B1, Q K^T, softmax, P V, B2
//   OVERLAP         issue i+A, wait_group A, B1, Q K^T, softmax, P V, B2
//   DROP_OFF        wait_group A-1, B0, K and V into registers, issue i+A,
//                   Q K^T, softmax, P V from registers, B2
//   TMA             thread 0 expect-tx + one bulk load per K and V row of
//                   i+A, all wait slot parity (i/depth)&1, B1, ..., B2
#include "async_pipeline.cuh"

namespace rt {

constexpr int FA_BQ = 128;                 // q rows of a block (the reference's bq)
constexpr int kRowPad = 16;                // bytes added to every K, V, q row pitch
constexpr float NEG_INF = -1e30f;

// kv rows of a ring slot, by strategy
__host__ __device__ constexpr int fa_kc(int s) { return s == DROP_OFF ? 4 : 32; }

constexpr int kPPitch = fa_kc(OVERLAP) + 16;   // P row pitch, floats (no bank conflicts)

__host__ __device__ constexpr int fa_pitch(int d) { return d * 4 + kRowPad; }

__host__ __device__ constexpr int fa_q_offset(int s, int depth, int d) {
  return ((s == SYNC ? 1 : depth) * 2 * fa_kc(s) * fa_pitch(d) +
          (s == TMA ? 8 * depth : 0) + 15) & ~15;
}
__host__ __device__ constexpr int fa_smem(int s, int depth, int d) {
  return fa_q_offset(s, depth, d) + FA_BQ * fa_pitch(d) +
         (s == DROP_OFF ? 0 : FA_BQ * kPPitch * 4);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
// the sum (or max) of v over the 16 lanes of this half-warp; every lane
// gets the same value (each step adds a pair in both lanes)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// What both bodies share: the block's q tile in shared memory, this
// thread's rows, its d columns of the accumulator, and the row max and
// denominator of its rows.
template <int D>
struct FlashState {
  static constexpr bool kCrossThreadReads = true;
  static constexpr int kPitch = fa_pitch(D) / 4;   // q, K, V row pitch, floats
  static constexpr int kDV = D / 64;               // float4 of the d columns a thread owns
  const float* q;
  int ty, tx, q0, kv0, causal, window;
  float m[8], l[8];
  float4 acc[8][kDV];

  __device__ __forceinline__ void init(const float* qs, int q_first, int kv_first, int c,
                                       int w) {
    q = qs;
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
    q0 = q_first;
    kv0 = kv_first;
    causal = c;
    window = w;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kDV; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ float4 q_at(int i, int j) const {
    return *reinterpret_cast<const float4*>(q + (ty + 16 * i) * kPitch + 64 * j + 4 * tx);
  }
  // One step of the online softmax for row i: mask the NC logits s, held
  // at kv positions kv0 + first + step * c, fold their max into m[i], turn
  // them into probabilities, update l[i] and rescale the row's accumulator.
  // kSpread: the row's other logits are in the other lanes of the half-warp.
  template <bool kSpread, int NC>
  __device__ __forceinline__ void softmax_row(int i, float (&s)[NC], int first, int step) {
    const int qi = q0 + ty + 16 * i;
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int kv = kv0 + first + step * c;
      if ((causal && kv > qi) || (window > 0 && kv <= qi - window)) s[c] = NEG_INF;
      mx = fmaxf(mx, s[c]);
    }
    if constexpr (kSpread) mx = half_warp_max(mx);
    const float mn = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - mn);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      s[c] = expf(s[c] - mn);
      sum += s[c];
    }
    if constexpr (kSpread) sum = half_warp_sum(sum);
    l[i] = l[i] * alpha + sum;
    m[i] = mn;
#pragma unroll
    for (int j = 0; j < kDV; ++j) {
      acc[i][j].x *= alpha;
      acc[i][j].y *= alpha;
      acc[i][j].z *= alpha;
      acc[i][j].w *= alpha;
    }
  }
  __device__ __forceinline__ void add_pv(int i, float p, const float4 (&v)[kDV]) {
#pragma unroll
    for (int j = 0; j < kDV; ++j) {
      acc[i][j].x = fmaf(p, v[j].x, acc[i][j].x);
      acc[i][j].y = fmaf(p, v[j].y, acc[i][j].y);
      acc[i][j].z = fmaf(p, v[j].z, acc[i][j].z);
      acc[i][j].w = fmaf(p, v[j].w, acc[i][j].w);
    }
  }
  // out: this q head's row q0; the reference's acc / max(l, 1e-30)
  __device__ __forceinline__ void drain(float* out) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float r = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kDV; ++j) {
        const float4 a = acc[i][j];
        *reinterpret_cast<float4*>(out + (ty + 16 * i) * D + 64 * j + 4 * tx) =
            make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
      }
    }
  }
};

// Every strategy but DROP_OFF: kc = 32 kv rows a slot, logits by full dots.
template <int D>
struct FlashBody : FlashState<D> {
  static constexpr int KC = fa_kc(OVERLAP);
  using FlashState<D>::kPitch;
  using FlashState<D>::kDV;
  float* p;   // shared: the probabilities, FA_BQ x kPPitch

  __device__ __forceinline__ void compute(const char* in, char*) {
    const float* K = reinterpret_cast<const float*>(in);
    const float* V = K + KC * kPitch;
    const int ty = this->ty, tx = this->tx;
    float s[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(K + tx * kPitch + d);
      const float4 k1 = *reinterpret_cast<const float4*>(K + (tx + 16) * kPitch + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(this->q + (ty + 16 * i) * kPitch + d);
        s[i][0] = dot4(qv, k0, s[i][0]);
        s[i][1] = dot4(qv, k1, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      this->template softmax_row<true, 2>(i, s[i], tx, 16);
      p[(ty + 16 * i) * kPPitch + tx] = s[i][0];
      p[(ty + 16 * i) * kPPitch + tx + 16] = s[i][1];
    }
    __syncwarp();   // a warp's rows of P are written and read by that warp only
#pragma unroll 2
    for (int c = 0; c < KC; c += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPPitch + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 v[kDV];
#pragma unroll
        for (int j = 0; j < kDV; ++j)
          v[j] = *reinterpret_cast<const float4*>(V + (c + cc) * kPitch + 64 * j + 4 * tx);
#pragma unroll
        for (int i = 0; i < 8; ++i) this->add_pv(i, lane_of(pv[i], cc), v);
      }
    }
    this->kv0 += KC;
  }
};

// DROP_OFF: kc = 4 kv rows a slot, held in registers at this thread's d
// columns; logits by partial dots summed across the half-warp.
template <int D>
struct FlashDropOffBody : FlashState<D> {
  static constexpr int KC = fa_kc(DROP_OFF);
  using FlashState<D>::kPitch;
  using FlashState<D>::kDV;
  float4 rk[KC][kDV], rv[KC][kDV];

  __device__ __forceinline__ void load(const char* in) {
    const float* K = reinterpret_cast<const float*>(in);
    const float* V = K + KC * kPitch;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int j = 0; j < kDV; ++j) {
        rk[c][j] = *reinterpret_cast<const float4*>(K + c * kPitch + 64 * j + 4 * this->tx);
        rv[c][j] = *reinterpret_cast<const float4*>(V + c * kPitch + 64 * j + 4 * this->tx);
      }
  }
  __device__ __forceinline__ void store(char*) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4 qv[kDV];
#pragma unroll
      for (int j = 0; j < kDV; ++j) qv[j] = this->q_at(i, j);
      float s[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < kDV; ++j) part = dot4(qv[j], rk[c][j], part);
        s[c] = half_warp_sum(part);
      }
      this->template softmax_row<false, KC>(i, s, 0, 1);
#pragma unroll
      for (int c = 0; c < KC; ++c) this->add_pv(i, s[c], rv[c]);
    }
    this->kv0 += KC;
  }
};

template <int D, int S, int A, int O>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* q, const float* k, const float* v, float* o, int h, int kvh,
             int s_len, int bk, int causal, int window, float scale, int depth) {
  constexpr int kc = fa_kc(S);
  constexpr int kPitch = fa_pitch(D) / 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;   // longest KV ranges first
  const long long head = static_cast<long long>(bh / h) * kvh + (bh % h) / (h / kvh);
  int hi = s_len / bk, lo = 0;
  if (causal) hi = min((q0 + FA_BQ + bk - 1) / bk, hi);
  if (window > 0) lo = max((q0 - window + 1) / bk, 0);   // a negative numerator clamps to 0

  float* qs = reinterpret_cast<float*>(smem + fa_q_offset(S, depth, D));
  const float* qg = q + (static_cast<long long>(bh) * s_len + q0) * D;
  for (int e = threadIdx.x; e < FA_BQ * D / 4; e += kThreads) {
    const int r = e / (D / 4), c = 4 * (e % (D / 4));
    float4 x = *reinterpret_cast<const float4*>(qg + r * D + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * kPitch + c) = x;
  }
  const long long first = (head * s_len + static_cast<long long>(lo) * bk) * D;
  const Operand op[2] = {
      {reinterpret_cast<const char*>(k + first), 4LL * D, 4LL * kc * D, kc, 4 * D,
       fa_pitch(D)},
      {reinterpret_cast<const char*>(v + first), 4LL * D, 4LL * kc * D, kc, 4 * D,
       fa_pitch(D)}};
  std::conditional_t<S == DROP_OFF, FlashDropOffBody<D>, FlashBody<D>> body;
  body.init(qs, q0, lo * bk, causal, window);
  if constexpr (S != DROP_OFF) body.p = qs + FA_BQ * kPitch;
  run_pipeline<S, A, O>(body, op, op[0], (hi - lo) * (bk / kc), depth);
  body.drain(o + (static_cast<long long>(bh) * s_len + q0) * D);
}

template <int D>
struct FlashLaunch {
  static constexpr bool kTileOutput = false;
  const float *q, *k, *v;
  float* o;
  int bh, h, kvh, s_len, bk, causal, window;
  float scale;
  int depth, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (bk % fa_kc(S) || smem < fa_smem(S, depth, D)) return kNotBuilt;
    auto kernel = flash_kernel<D, S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(bh, s_len / FA_BQ), kThreads, smem, stream>>>(
        q, k, v, o, h, kvh, s_len, bk, causal, window, scale, depth);
    return cudaGetLastError();
  }
};

}  // namespace rt

// o (bh, s, d) = attention of q (bh, s, d) over k, v (bh / h * kvh, s, d),
// all f32, contiguous and 16-byte aligned; bh = B * h flattened q heads,
// h % kvh == 0, s % 128 == 0 and s % bk == 0, d in {64, 128}.  causal and
// window (> 0: a sliding window) mask as the reference.  One launch on
// `stream`, no synchronisation; returns a cudaError_t.
extern "C" int flash_attention_launch(int device, int strategy, int ahead, int depth,
                                      const void* q, const void* k, const void* v,
                                      void* o, int bh, int h, int kvh, int s, int d,
                                      int bk, int causal, int window, float scale,
                                      int smem, void* stream) {
  if (bh < 1 || h < 1 || kvh < 1 || h % kvh || bh % h || s < 1 || s % rt::FA_BQ ||
      bk < 1 || s % bk || !rt::aligned16(q) || !rt::aligned16(k) || !rt::aligned16(v) ||
      !rt::aligned16(o))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return rt::dispatch(strategy, ahead, 0,
                        rt::FlashLaunch<64>{qf, kf, vf, of, bh, h, kvh, s, bk, causal,
                                            window, scale, depth, smem, st});
  if (d == 128)
    return rt::dispatch(strategy, ahead, 0,
                        rt::FlashLaunch<128>{qf, kf, vf, of, bh, h, kvh, s, bk, causal,
                                             window, scale, depth, smem, st});
  return rt::kNotBuilt;
}
