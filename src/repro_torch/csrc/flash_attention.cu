// Flash attention for Hopper: causal and/or sliding-window online-softmax
// attention with grouped KV heads, f32 or bf16 in and f32 out, both
// products on the tensor cores as 3xTF32 (f32 inputs) or as its two
// products that a bf16 K or V leaves (bf16 inputs).
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
// 235 MB of q, k, v and out.  One TF32 product keeps 10 bits of each
// operand and misses the reference's 2e-5 (about 9e-4 at s = 1024, d =
// 128: tests/test_torch_flash_attention.py replays it).  3xTF32 keeps 21:
// x = hi + lo with hi = tf32(x) and lo = x - hi, and a b = lo_a hi_b + hi_a
// lo_b + hi_a hi_b, where the lo lo term left out is ~2^-22 of the product
// and each tf32 product is exact in the f32 accumulator, so the error is
// within a few f32 roundings of the product.  Each 16 x 8 x 8 step is three
// mma.sync m16n8k8 tf32 (lo hi, hi lo, then hi hi: CUTLASS's
// OpMultiplyAddFastF32 order):
// 3 x 206.2 GFLOP of tensor work, 1.25 ms at the 495 TFLOP/s dense TF32
// rate (the f32 products on FFMA would take 3.08 ms at 66.9 TFLOP/s).
// mma.sync reaches less than that rate (chip_smoke.py probes it), and each
// warp also splits every operand it reads, three integer and float
// operations a value: 336 values a warp and 32-row slot (q, K, V, P)
// beside 384 mma steps (PERF.md, section 5, has the times).
// mma.sync, not wgmma: TF32 wgmma reads only K-major operands from shared
// memory, V is MN-major in P V, and hi/lo copies would double the ring;
// mma.sync fragments come from plain shared loads in any layout.
//
// Numerics are the reference's: q is scaled in f32 before the product,
// masked logits are NEG_INF = -1e30 (not -inf), the running max starts at
// NEG_INF and the denominator at 0, and the output is acc / max(l, 1e-30).
//
// Work split (FlashAttention-2): warp w owns q rows 16 w .. 16 w + 15 of the
// block; its logits S (16 x kc) and its output O (16 x D) live in mma
// accumulator fragments.  Lane (g, t) = (lane / 4, lane % 4) holds rows g
// and g + 8.  The 8 columns n of an n-block of S are KV rows sigma(n) =
// n / 2 + 4 (n % 2) of the sub-tile, so that the accumulator's columns 2t
// and 2t + 1 are KV rows t and t + 4: exactly the columns t and t + 4 of
// P V's A fragment.  P goes from S's registers to P V's A fragment with no
// shuffle and no shared memory, and V's B fragment is V's rows t and t + 4.
// The row max is reduced over the quad (2 shuffles); each lane keeps its own
// share of the denominator, summed over the quad once at the end.
//
// The contraction index of an mma step is a free label, and so are the
// columns of O until they are stored.  Q K^T: k-steps 2j and 2j + 1 take d
// = 16 j + 4 t + {0, 1} and + {2, 3}, so that one float4 of a q row and one
// of a K row feed two steps.  P V: the 4 n-blocks 4c + i take O columns d =
// 32 c + off(n) + i, off(n) = 16 (n % 2) + 4 (n / 2), so that one float4 of
// a V row feeds four; the accumulator's columns 2t, 2t + 1 are then d =
// 32 c + 4 t + i and 32 c + 16 + 4 t + i, whole float4 of O.  With the
// 16-byte row pad (pitch = 4 floats mod 32 banks) each quarter warp's
// float4 loads of K (rows sigma(g)) and V (rows t, t + 4) fall in 8
// distinct 4-bank groups: no bank conflicts.
//
// Shared memory: run_pipeline's [ring][TMA mbarriers] (no out ring: the
// launcher declares kTileOutput = false), then at the next 16 bytes the
// block's scaled q tile (128 x D f32, no pad), stored in fragment order:
// warp w's float4 for k-pair j, row half h (rows g, g + 8) and lane L at
// ((w * D / 16 + j) * 2 + h) * 32 + L, so each warp reads 512 contiguous
// bytes a load.  Every K and V row pitch is its bytes + 16.  Every strategy
// has a barrier (B1, or B0 for DROP_OFF) before its first compute, which
// orders the q tile's stores before the reads.  q is split into hi and lo
// as each fragment is read, as K, V and P are (q's hi and lo kept in shared
// memory would need 16-row slots to fit depth 4; that was slower).
//
// Slots: kc = 32 KV rows for every strategy but DROP_OFF (four n-blocks of
// S, four k-steps of P V).  DROP_OFF holds one mma step, kc = 8, in
// registers: the K and V B fragments of its slot, 64 floats at D = 128; its
// one n-block of S sums the even and odd k-pairs in two accumulators.
//
// Barriers per sub-tile (see async_pipeline.cuh for the loop; O = 0):
//   SYNC            ld.global/st.shared staging, B1, Q K^T, softmax, P V, B2
//   REGISTER_BYPASS cp.async, wait_group 0, B1, Q K^T, softmax, P V, B2
//   OVERLAP         issue i+A, wait_group A, B1, Q K^T, softmax, P V, B2
//   DROP_OFF        wait_group A-1, B0, K and V into registers, issue i+A,
//                   Q K^T, softmax, P V from registers, B2
//   TMA             thread 0 expect-tx + one bulk load per K and V row of
//                   i+A, all wait slot parity (i/depth)&1, B1, ..., B2
// One block an SM (__launch_bounds__(256, 1): up to 255 registers a thread).
//
// bf16 inputs (flash_attention_bf16_launch; EB, the bytes of an element, is
// 2): as in the reference, which keeps its q tile and K/V slots in the
// input type and computes in f32, the ring holds K and V in bf16 (half the
// f32 ring's bytes) and q is widened and scaled in f32 into the same
// fragment-order tile.  Every bf16 value is exact in TF32 (8 significand
// bits of 11), so a K or V value's split has lo = 0 and 3xTF32 keeps two
// products: lo_q K + hi_q K for Q K^T and lo_p V + hi_p V for P V, the
// same sums as the three.  A lane still loads 16 bytes at a time, now 8
// values: with E values a 16-byte chunk (4 for f32, 8 for bf16), K chunk j
// of a lane holds d = 4 E j + E t .. + E - 1 (q pairs (E / 4) j .. of 16
// columns each, labelled to match), and V's n-blocks E c + i take O columns
// 8 E c + off(n) + i, off(n) = 4 E (n % 2) + E (n / 2).  At a K/V pitch of
// 2 D + 16 bytes (4 banks mod 32) a quarter warp's 16-byte loads of K
// (rows sigma(g), g = 0, 1: rows 0 and 4) and of V (rows t, t + 4 at off(0)
// and off(1)) fall in distinct banks.
#include "async_pipeline.cuh"

namespace rt {

constexpr int FA_BQ = 128;                 // q rows of a block (the reference's bq)
constexpr int kRowPad = 16;                // bytes added to every K and V row pitch
constexpr float NEG_INF = -1e30f;

// kv rows of a ring slot, by strategy
__host__ __device__ constexpr int fa_kc(int s) { return s == DROP_OFF ? 8 : 32; }

// K and V row pitch in shared memory at EB bytes an element
__host__ __device__ constexpr int fa_pitch(int d, int eb) { return d * eb + kRowPad; }

__host__ __device__ constexpr int fa_q_offset(int s, int depth, int d, int eb) {
  return ((s == SYNC ? 1 : depth) * 2 * fa_kc(s) * fa_pitch(d, eb) +
          (s == TMA ? 8 * depth : 0) + 15) & ~15;
}
__host__ __device__ constexpr int fa_smem(int s, int depth, int d, int eb) {
  return fa_q_offset(s, depth, d, eb) + FA_BQ * d * 4;
}

// ------------------------------------------------------------ 3xTF32 --

// x = hi + lo: hi = tf32(x), rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32, which ptxas expands to four instructions with a NaN
// check; an integer add and mask give the same bits for every finite x),
// and lo = x - hi, exact in f32, which the tensor core reads as a tf32 by
// ignoring its low 13 bits (rounding it toward zero)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d (16 x 8) += a (16 x 8) b (8 x 8), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in 3xTF32: lo hi, hi lo, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Element e of a 16-byte chunk as f32 bits: word e at EB = 4; at EB = 2 the
// bf16 in half e % 2 of word e / 2, widened exactly (its bits on top)
template <int EB>
__device__ __forceinline__ uint32_t elem(const uint4& c, int e) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  if constexpr (EB == 2) {
    const uint32_t x = w[e / 2];
    return e % 2 ? x & 0xffff0000u : x << 16;
  } else {
    return w[e];
  }
}

// d += a b for one mma step whose B fragment is the values x0, x1 (f32
// bits): 3xTF32 at EB = 4; at EB = 2 the values are exact in tf32 (lo = 0),
// so lo hi and hi hi alone
template <int EB>
__device__ __forceinline__ void mma_b(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t x0, uint32_t x1) {
  if constexpr (EB == 2) {
    const uint32_t b[2] = {x0, x1};
    mma_tf32(d, al, b);
    mma_tf32(d, ah, b);
  } else {
    uint32_t bh[2], bl[2];
    split(__uint_as_float(x0), bh[0], bl[0]);
    split(__uint_as_float(x1), bh[1], bl[1]);
    mma3(d, ah, al, bh, bl);
  }
}

__device__ __forceinline__ uint4 ld16(const char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// What both bodies share: the warp's q fragments in shared memory, its rows'
// running max and denominator share, and its O fragments.  EB: the bytes of
// a K or V element (4: f32, 2: bf16); E: its values in a 16-byte chunk.
template <int D, int EB>
struct FlashState {
  static constexpr bool kCrossThreadReads = true;
  static constexpr int E = 16 / EB;
  static constexpr int kPitch = fa_pitch(D, EB);   // K, V row pitch, bytes
  static constexpr int kChunks = D / (4 * E);      // K chunks of a row a lane reads
  static constexpr int kGroups = D / (8 * E);      // V chunks of a row a lane reads
  const float4* q;   // this warp's q fragments
  int lane, g, t;
  int krow;          // sigma(g): the K row of this lane's S column
  int vcol;          // off(g): this lane's first V column of a group of 8 E
  int row;           // row g of the block: 16 w + g
  int q0, kv0, causal, window;
  float m[2], l[2];  // rows g and g + 8
  float o[D / 8][4];

  __device__ __forceinline__ void init(const float4* qs, int q_first, int kv_first, int c,
                                       int w) {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
    krow = g / 2 + 4 * (g % 2);
    vcol = 4 * E * (g % 2) + E * (g / 2);
    q = qs + warp * (D / 16) * 64;
    row = 16 * warp + g;
    q0 = q_first;
    kv0 = kv_first;
    causal = c;
    window = w;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  }

  // q's A fragments of k-steps 2j and 2j + 1, split
  struct QFrag {
    uint32_t h[2][4], l[2][4];
  };
  __device__ __forceinline__ QFrag q_frag(int j) const {
    const float4 a = q[2 * j * 32 + lane], b = q[(2 * j + 1) * 32 + lane];   // rows g, g + 8
    QFrag f;
    split(a.x, f.h[0][0], f.l[0][0]);
    split(b.x, f.h[0][1], f.l[0][1]);
    split(a.y, f.h[0][2], f.l[0][2]);
    split(b.y, f.h[0][3], f.l[0][3]);
    split(a.z, f.h[1][0], f.l[1][0]);
    split(b.z, f.h[1][1], f.l[1][1]);
    split(a.w, f.h[1][2], f.l[1][2]);
    split(b.w, f.h[1][3], f.l[1][3]);
    return f;
  }
  // s += Q K^T over q pair (E / 4) j + hf: kk is K chunk j of row krow,
  // values 4 hf .. 4 hf + 3 of it the pair's
  __device__ __forceinline__ static void qk(float (&s)[4], const QFrag& f, const uint4& kk,
                                            int hf) {
    mma_b<EB>(s, f.h[0], f.l[0], elem<EB>(kk, 4 * hf), elem<EB>(kk, 4 * hf + 1));
    mma_b<EB>(s, f.h[1], f.l[1], elem<EB>(kk, 4 * hf + 2), elem<EB>(kk, 4 * hf + 3));
  }

  // One step of the online softmax over NB n-blocks of logits: mask, fold
  // the quad's max into m, turn s into probabilities, add this lane's share
  // to l and rescale O.  s[n][c] is q row g + 8 (c / 2), KV row kv0 + 8 n +
  // t + 4 (c % 2).
  template <int NB>
  __device__ __forceinline__ void softmax(float (&s)[NB][4]) {
    const int q_lo = q0 + row - g, q_hi = q_lo + 15;   // the warp's rows
    const bool mask = (causal && kv0 + 8 * NB - 1 > q_lo) ||
                      (window > 0 && kv0 <= q_hi - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * r + e];
          const int kv = kv0 + 8 * n + t + 4 * e;
          if (mask && ((causal && kv > qi) || (window > 0 && kv <= qi - window)))
            x = NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * r + e];
          x = expf(x - mn);
          sum += x;
        }
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
  }

  // O += P V for one k-step of 8 KV rows: p is that n-block of S (its
  // columns 2t, 2t + 1 are KV rows t, t + 4: P's A-fragment columns t, t +
  // 4); v0[c], v1[c] are V rows t and t + 4 at columns 8 E c + vcol .. + E - 1.
  __device__ __forceinline__ void pv(const float (&p)[4], const uint4 (&v0)[kGroups],
                                     const uint4 (&v1)[kGroups]) {
    uint32_t ah[4], al[4];
    split(p[0], ah[0], al[0]);
    split(p[2], ah[1], al[1]);
    split(p[1], ah[2], al[2]);
    split(p[3], ah[3], al[3]);
#pragma unroll
    for (int c = 0; c < kGroups; ++c)
#pragma unroll
      for (int i = 0; i < E; ++i)
        mma_b<EB>(o[E * c + i], ah, al, elem<EB>(v0[c], i), elem<EB>(v1[c], i));
  }

  // out: this q head's row q0; the reference's acc / max(l, 1e-30).  The
  // accumulator's column 2t + e of n-block E c + i is O column 8 E c + 4 E e
  // + E t + i.
  __device__ __forceinline__ void drain(float* out) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.0f / fmaxf(sum, 1e-30f);
      float* dst = out + (row + 8 * r) * D;
#pragma unroll
      for (int c = 0; c < kGroups; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < E; i += 4) {
            const int k = 2 * r + e;
            *reinterpret_cast<float4*>(dst + 8 * E * c + 4 * E * e + E * t + i) =
                make_float4(o[E * c + i][k] * inv, o[E * c + i + 1][k] * inv,
                            o[E * c + i + 2][k] * inv, o[E * c + i + 3][k] * inv);
          }
    }
  }
};

// Every strategy but DROP_OFF: kc = 32 KV rows a slot, read from shared
// memory.
template <int D, int EB>
struct FlashBody : FlashState<D, EB> {
  static constexpr int KC = fa_kc(OVERLAP);
  static constexpr int NB = KC / 8;
  using FlashState<D, EB>::E;
  using FlashState<D, EB>::kPitch;
  using FlashState<D, EB>::kChunks;
  using FlashState<D, EB>::kGroups;

  __device__ __forceinline__ void compute(const char* in, char*) {
    const char* K = in;
    const char* V = K + KC * kPitch;
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    const char* kr = K + this->krow * kPitch + 16 * this->t;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      uint4 kk[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) kk[n] = ld16(kr + 8 * n * kPitch + 64 * j);
#pragma unroll
      for (int hf = 0; hf < E / 4; ++hf) {
        const auto f = this->q_frag(j * (E / 4) + hf);
#pragma unroll
        for (int n = 0; n < NB; ++n) this->qk(s[n], f, kk[n], hf);
      }
    }
    this->softmax(s);
    const char* vr = V + this->t * kPitch + this->vcol * EB;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint4 v0[kGroups], v1[kGroups];
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        v0[c] = ld16(vr + 8 * n * kPitch + 128 * c);
        v1[c] = ld16(vr + (8 * n + 4) * kPitch + 128 * c);
      }
      this->pv(s[n], v0, v1);
    }
    this->kv0 += KC;
  }
};

// DROP_OFF: kc = 8 KV rows a slot, one mma step, held in registers as the
// K and V B fragments of this lane.
template <int D, int EB>
struct FlashDropOffBody : FlashState<D, EB> {
  static constexpr int KC = fa_kc(DROP_OFF);
  using FlashState<D, EB>::E;
  using FlashState<D, EB>::kPitch;
  using FlashState<D, EB>::kChunks;
  using FlashState<D, EB>::kGroups;
  uint4 rk[kChunks], rv0[kGroups], rv1[kGroups];

  __device__ __forceinline__ void load(const char* in) {
    const char* K = in;
    const char* V = K + KC * kPitch;
    const char* kr = K + this->krow * kPitch + 16 * this->t;
    const char* vr = V + this->t * kPitch + this->vcol * EB;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) rk[j] = ld16(kr + 64 * j);
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      rv0[c] = ld16(vr + 128 * c);
      rv1[c] = ld16(vr + 4 * kPitch + 128 * c);
    }
  }
  // Q K^T of one n-block: the even and the odd q pairs into two
  // accumulators, so that two chains of dependent mma steps overlap
  __device__ __forceinline__ void store(char*) {
    float s[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}}, odd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int hf = 0; hf < E / 4; ++hf) {
        const int jj = j * (E / 4) + hf;
        this->qk(jj % 2 ? odd : s[0], this->q_frag(jj), rk[j], hf);
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) s[0][c] += odd[c];
    this->softmax(s);
    this->pv(s[0], rv0, rv1);
    this->kv0 += KC;
  }
};

// EB: the bytes of an element of q, k and v (4: f32, 2: bf16)
template <int D, int S, int A, int O, int EB>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const char* q, const char* k, const char* v, float* o, int h, int kvh,
             int s_len, int bk, int causal, int window, float scale, int depth) {
  constexpr int kc = fa_kc(S);
  constexpr int E = 16 / EB;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;   // longest KV ranges first
  const long long head = static_cast<long long>(bh / h) * kvh + (bh % h) / (h / kvh);
  int hi = s_len / bk, lo = 0;
  if (causal) hi = min((q0 + FA_BQ + bk - 1) / bk, hi);
  if (window > 0) lo = max((q0 - window + 1) / bk, 0);   // a negative numerator clamps to 0

  // the scaled q tile in f32, in fragment order: row r = 16 w + 8 h + g,
  // columns c = 4 E j + E t + 4 hf .. + 3 go to float4 ((w * D / 16 + (E /
  // 4) j + hf) * 2 + h) * 32 + 4 g + t; a thread reads one 16-byte chunk
  // of E values at a time
  float4* qs = reinterpret_cast<float4*>(smem + fa_q_offset(S, depth, D, EB));
  const char* qg = q + (static_cast<long long>(bh) * s_len + q0) * D * EB;
  for (int e = threadIdx.x; e < FA_BQ * D / E; e += kThreads) {
    const int r = e / (D / E), c0 = E * (e % (D / E));
    const uint4 x = ld16(qg + (r * D + c0) * EB);
#pragma unroll
    for (int hf = 0; hf < E / 4; ++hf) {
      const int c = c0 + 4 * hf;
      const int jj = (c / (4 * E)) * (E / 4) + hf, tt = (c % (4 * E)) / E;
      qs[(((r / 16) * (D / 16) + jj) * 2 + (r / 8) % 2) * 32 + 4 * (r % 8) + tt] =
          make_float4(__uint_as_float(elem<EB>(x, 4 * hf)) * scale,
                      __uint_as_float(elem<EB>(x, 4 * hf + 1)) * scale,
                      __uint_as_float(elem<EB>(x, 4 * hf + 2)) * scale,
                      __uint_as_float(elem<EB>(x, 4 * hf + 3)) * scale);
    }
  }
  const long long first = (head * s_len + static_cast<long long>(lo) * bk) * D * EB;
  const Operand op[2] = {
      {k + first, 1LL * EB * D, 1LL * EB * kc * D, kc, EB * D, fa_pitch(D, EB)},
      {v + first, 1LL * EB * D, 1LL * EB * kc * D, kc, EB * D, fa_pitch(D, EB)}};
  std::conditional_t<S == DROP_OFF, FlashDropOffBody<D, EB>, FlashBody<D, EB>> body;
  body.init(qs, q0, lo * bk, causal, window);
  run_pipeline<S, A, O>(body, op, op[0], (hi - lo) * (bk / kc), depth);
  body.drain(o + (static_cast<long long>(bh) * s_len + q0) * D);
}

template <int D, int EB>
struct FlashLaunch {
  static constexpr bool kTileOutput = false;
  const char *q, *k, *v;
  float* o;
  int bh, h, kvh, s_len, bk, causal, window;
  float scale;
  int depth, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (bk % fa_kc(S) || smem < fa_smem(S, depth, D, EB)) return kNotBuilt;
    auto kernel = flash_kernel<D, S, A, O, EB>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(bh, s_len / FA_BQ), kThreads, smem, stream>>>(
        q, k, v, o, h, kvh, s_len, bk, causal, window, scale, depth);
    return cudaGetLastError();
  }
};

// The launchers' shared body at EB bytes an element
template <int EB>
int flash_launch(int device, int strategy, int ahead, int depth, const void* q, const void* k,
                 const void* v, void* o, int bh, int h, int kvh, int s, int d, int bk,
                 int causal, int window, float scale, int smem, void* stream) {
  if (bh < 1 || h < 1 || kvh < 1 || h % kvh || bh % h || s < 1 || s % FA_BQ || bk < 1 ||
      s % bk || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const char *qc = static_cast<const char*>(q), *kc = static_cast<const char*>(k),
             *vc = static_cast<const char*>(v);
  float* of = static_cast<float*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return dispatch(strategy, ahead, 0,
                    FlashLaunch<64, EB>{qc, kc, vc, of, bh, h, kvh, s, bk, causal, window,
                                        scale, depth, smem, st});
  if (d == 128)
    return dispatch(strategy, ahead, 0,
                    FlashLaunch<128, EB>{qc, kc, vc, of, bh, h, kvh, s, bk, causal, window,
                                         scale, depth, smem, st});
  return kNotBuilt;
}

// The rate of the instruction both products are built from: kRateChains
// independent mma.sync m16n8k8 tf32 a warp, iters times, kThreads threads
// a block.  chip_smoke.py launches one block an SM and prints the TF32 rate
// mma.sync reaches on the card, the floor of this design (the data sheet's
// 495 TFLOP/s is wgmma's).
constexpr int kRateChains = 8;

__global__ void __launch_bounds__(kThreads, 1) mma_rate_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = tf32_bits(1.0f + threadIdx.x * 1e-3f + i);
#pragma unroll
  for (int i = 0; i < 2; ++i) b[i] = tf32_bits(0.5f - threadIdx.x * 1e-3f + i);
  float acc[kRateChains][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < kRateChains; ++c) mma_tf32(acc[c], a, b);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kRateChains; ++c) sum += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace rt

// The mma.sync rate probe: `blocks` blocks of rt::kThreads, each thread
// rt::kRateChains x iters mma steps, writing one float a thread to out.
extern "C" int flash_mma_rate_launch(int device, int blocks, int iters, void* out,
                                     void* stream) {
  if (blocks < 1 || iters < 1) return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  rt::mma_rate_kernel<<<blocks, rt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return cudaGetLastError();
}

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
  return rt::flash_launch<4>(device, strategy, ahead, depth, q, k, v, o, bh, h, kvh, s, d,
                             bk, causal, window, scale, smem, stream);
}

// The same with q, k and v in bf16 (o stays f32)
extern "C" int flash_attention_bf16_launch(int device, int strategy, int ahead, int depth,
                                           const void* q, const void* k, const void* v,
                                           void* o, int bh, int h, int kvh, int s, int d,
                                           int bk, int causal, int window, float scale,
                                           int smem, void* stream) {
  return rt::flash_launch<2>(device, strategy, ahead, depth, q, k, v, o, bh, h, kvh, s, d,
                             bk, causal, window, scale, smem, stream);
}
