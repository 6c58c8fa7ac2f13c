// Flash attention for Hopper: causal and/or sliding-window online-softmax
// attention with grouped KV heads, f32 or bf16 in and f32 out.  Two
// designs: f32 inputs run both products as 3xTF32 mma.sync
// (flash_kernel); bf16 inputs run both on bf16 wgmma (flash_bf16_kernel,
// at the end of the note).
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_pallas
// (line 107) and its body _flash_kernel (line 27), with the batch dims that
// ops.py vmaps (line 255) folded into the grid: block (x, y) is q head x of
// the (B * H) flattened heads and q block y of FA_BQ = 128 rows; it reads KV
// head (x / H) * KVH + (x % H) / (H / KVH).  The KV range is pruned exactly
// as there, in units of the reference's bk:
//   hi = min(ceil((q0 + 128) / bk), S / bk) if causal, else S / bk
//   lo = max((q0 - window + 1) // bk, 0)    if window > 0, else 0
// then cut to the key count kv_len (1 <= kv_len <= S; the reference's
// kernel has none, and kv_len = S is its call): keys at index kv_len and
// past are masked for every query, and the tiles wholly past them are not
// read, hi = min(hi, ceil(kv_len / bk)).  A caller that pads S up to a
// multiple of 128 passes its true length, so that a non-causal query never
// sees the zero keys of the padding.
// and rows lo * bk .. hi * bk stream through the strategy's ring as two
// Operands (K and V), kc rows a ring slot: on the card bk is cut into kc-row
// sub-tiles so that a ring of depth 4 fits a block's shared memory (one K+V
// slot at bk = 128, D = 128 is 128 KB).  The blocks of the last q blocks
// have the longest KV ranges; blockIdx.y runs from the last q block down,
// so they start first.
//
// The f32 design (flash_kernel).  Bound: operations.  At the
// h100/flash_attention shape (b, h, kvh, s, d) = (4, 12, 2, 4096, 128),
// causal, the two products are 206.2 GFLOP against
// 235 MB of q, k, v and out.  One TF32 product keeps 10 bits of each
// operand and misses the reference's 2e-5 (about 9e-4 at s = 1024, d =
// 128: tests/test_torch_flash_attention.py replays it).  3xTF32 keeps 21
// (csrc/mma_tf32.cuh, shared with the backward's f32 design):
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
// The bf16 design (flash_bf16_kernel, flash_attention_bf16_launch).  As
// in the reference, which keeps its q tile and K/V slots in the input type
// and computes in f32, q, K and V stay bf16 in shared memory, and both
// products run on bf16 wgmma (m64nNk16, f32 accumulators), the only way to
// the card's full tensor-core rate.  Bound: operations, 1 + t bf16
// products at 989 TFLOP/s:
//   Q K^T is one product: a bf16 product is exact in the f32 accumulator.
//     The softmax scale is applied to the f32 logits after it, not to q
//     before it, as the reference does, and folded with log2(e) into one
//     f32 factor, so that the softmax's exponentials are exp2f (two
//     departures from the reference's order of operations, each an f32
//     rounding).
//   P V keeps the reference's f32 P: each P value is split into t = 3 bf16
//     terms (hi = bf16(p), then the bf16 of each exact f32 remainder), and
//     each k16 step runs t products into the one O accumulator, smallest
//     term first, on the same V operand.  Three terms sum back to p
//     exactly (8 of its 24 significand bits each), so P V is the f32 P's.
//     The CPU replay (tests/test_torch_flash_attention.py, wgmma_replay)
//     gives 8.34e-7 against float64 at s = 1024, d = 128, causal, on bf16
//     inputs (the f32 plain version 4.47e-7); t = 2 gives 2.98e-6, within
//     half the reference's 2e-5 too, at a quarter less tensor work, and t
//     = 1 2.3e-3.  t = 3 keeps the f32 P that the bound assumes.
// At the h100 shape that is 4 x 103.1 GFLOP, 0.4169 ms at 989 TFLOP/s.
// Block: 256 threads, two warpgroups of 64 q rows each (warp w owns rows
// 16 w .. 16 w + 15, as above); grid, GQA, KV pruning, the key count and
// the masks as above.  The q tile (128 x D bf16, unscaled) is loaded once a
// block into D / 64 parts of 128 rows x 128 bytes in the 128-byte swizzle
// (chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4)), the K-major A of
// Q K^T.  A ring slot is K's parts then V's, kc rows x 128 bytes each in
// the same swizzle, with no row pad, the ring base on 1024 bytes: kc = 64
// (32 KB at D = 128; at depth 4, with the 32 KB q tile, 164,864 bytes),
// so that Q K^T is m64n64k16 with K as a K-major B (D / 16 steps) and P V
// m64nDk16 with V as an MN-major B (imm-trans-b = 1, LBO the next 64
// columns, 4 steps).  The logits S (32 f32 a thread) and O (D / 2) are
// wgmma accumulators; the online softmax runs on them in place (mask, quad
// max, per-lane denominator share, as above), and P goes from S's
// registers to wgmma_rs's A fragment with no shuffle: the m16n8k16 A
// fragment of KV rows 16 s .. 16 s + 15 is n-blocks 2 s and 2 s + 1 of the
// accumulator layout.  Every strategy fences the async proxy before B1
// (kAsyncProxyReads), and each slot ends in wgmma.wait_group 0 before B2,
// so that run_pipeline may refill it.
// Barriers per sub-tile (O = 0):
//   SYNC            ld.global/st.shared into the swizzled slot, B1, Q K^T
//                   (wgmma), softmax, P V (wgmma), B2
//   REGISTER_BYPASS cp.async (16 B) to swizzled addresses, wait_group 0,
//                   B1, ..., B2
//   OVERLAP         cp.async of i+A, wait_group A, B1, ..., B2
//   DROP_OFF        kc = 16: wait_group A-1, B0, the slot into registers
//                   (K's m16n8k16 B fragments by ldmatrix, V's by
//                   ldmatrix.trans: 64 registers at D = 128), issue i+A,
//                   then bf16 mma.sync m16n8k16 from registers: Q K^T (q's
//                   A fragments by ldmatrix from the q tile, even and odd
//                   k16 steps in two sums), softmax, P V as t products a
//                   step, B2; the slot is free once loaded (wgmma reads B
//                   only from shared memory, so DROP_OFF runs mma.sync)
//   TMA             thread 0 expect-tx, then i+A as one box a K and a V
//                   part (64 columns x kc rows) from 2-D tensor maps in
//                   CU_TENSOR_MAP_SWIZZLE_128B, all wait slot parity
//                   (i/depth)&1, B1, ..., B2
#include <cuda_bf16.h>

#include "async_pipeline.cuh"
#include "mma_tf32.cuh"
#include "wgmma.cuh"

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

// Element e of a 16-byte chunk as f32 bits (this design is built for EB = 4)
template <int EB>
__device__ __forceinline__ uint32_t elem(const uint4& c, int e) {
  static_assert(EB == 4, "the mma.sync design takes f32 inputs");
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  return w[e];
}

// d += a b for one mma step whose B fragment is the values x0, x1 (f32
// bits), in 3xTF32
template <int EB>
__device__ __forceinline__ void mma_b(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t x0, uint32_t x1) {
  uint32_t bh[2], bl[2];
  split(__uint_as_float(x0), bh[0], bl[0]);
  split(__uint_as_float(x1), bh[1], bl[1]);
  mma3(d, ah, al, bh, bl);
}

__device__ __forceinline__ uint4 ld16(const char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// What both bodies share: the warp's q fragments in shared memory, its rows'
// running max and denominator share, and its O fragments.  EB: the bytes of
// a K or V element (4: f32); E: its values in a 16-byte chunk.
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
  int q0, kv0, window;
  int last[2];       // rows g, g + 8: their last key, min(row, kv_len - 1) if causal
  int last_lo;       // the least of the warp's rows' last keys
  float m[2], l[2];  // rows g and g + 8
  float o[D / 8][4];

  __device__ __forceinline__ void init(const float4* qs, int q_first, int kv_first,
                                       int causal, int w, int kv_len) {
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
    window = w;
    // the causal mask and the key count as one last key a row: masked
    // past it, so that the loop tests one bound whichever the call has
    last_lo = causal ? min(q0 + row - g, kv_len - 1) : kv_len - 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      last[r] = causal ? min(q0 + row + 8 * r, kv_len - 1) : kv_len - 1;
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

  // One step of the online softmax over NB n-blocks of logits: mask (keys
  // past a row's last key, and the window), fold
  // the quad's max into m, turn s into probabilities, add this lane's share
  // to l and rescale O.  s[n][c] is q row g + 8 (c / 2), KV row kv0 + 8 n +
  // t + 4 (c % 2).
  template <int NB>
  __device__ __forceinline__ void softmax(float (&s)[NB][4]) {
    const int q_hi = q0 + row - g + 15;   // the warp's last row
    const bool mask = kv0 + 8 * NB - 1 > last_lo || (window > 0 && kv0 <= q_hi - window);
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
          if (mask && (kv > last[r] || (window > 0 && kv <= qi - window))) x = NEG_INF;
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

// EB: the bytes of an element of q, k and v (4: f32)
template <int D, int S, int A, int O, int EB>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const char* q, const char* k, const char* v, float* o, int h, int kvh,
             int s_len, int kv_len, int bk, int causal, int window, float scale,
             int depth) {
  constexpr int kc = fa_kc(S);
  constexpr int E = 16 / EB;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;   // longest KV ranges first
  const long long head = static_cast<long long>(bh / h) * kvh + (bh % h) / (h / kvh);
  int hi = s_len / bk, lo = 0;
  if (causal) hi = min((q0 + FA_BQ + bk - 1) / bk, hi);
  if (window > 0) lo = max((q0 - window + 1) / bk, 0);   // a negative numerator clamps to 0
  hi = min(hi, (kv_len + bk - 1) / bk);
  hi = max(hi, lo);   // a window wholly past kv_len: no tile, an output row of 0

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
  body.init(qs, q0, lo * bk, causal, window, kv_len);
  run_pipeline<S, A, O>(body, op, op[0], (hi - lo) * (bk / kc), depth);
  body.drain(o + (static_cast<long long>(bh) * s_len + q0) * D);
}

template <int D, int EB>
struct FlashLaunch {
  static constexpr bool kTileOutput = false;
  const char *q, *k, *v;
  float* o;
  int bh, h, kvh, s_len, kv_len, bk, causal, window;
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
        q, k, v, o, h, kvh, s_len, kv_len, bk, causal, window, scale, depth);
    return cudaGetLastError();
  }
};

// --------------------------------------------------------------- bf16 --

constexpr int kFa16Align = 1024;           // SWIZZLE_128B atoms
constexpr int kPTerms = 3;                 // bf16 terms of each f32 P value
constexpr float kLog2e = 1.44269504088896340736f;

// kv rows of a bf16 ring slot, by strategy
__host__ __device__ constexpr int fa16_kc(int s) { return s == DROP_OFF ? 16 : 64; }
// bytes of a bf16 slot: K, then V, each D / 64 parts of kc rows x 128 bytes
__host__ __device__ constexpr int fa16_slot(int s, int d) { return 2 * fa16_kc(s) * d * 2; }
// the q tile's offset from the ring base (rounded up to kFa16Align), past
// the ring and the TMA mbarriers, on kFa16Align
__host__ __device__ constexpr int fa16_q_offset(int s, int depth, int d) {
  return ((s == SYNC ? 1 : depth) * fa16_slot(s, d) + (s == TMA ? 8 * depth : 0) +
          kFa16Align - 1) / kFa16Align * kFa16Align;
}
__host__ __device__ constexpr int fa16_smem(int s, int depth, int d) {
  return kFa16Align + fa16_q_offset(s, depth, d) + FA_BQ * d * 2;
}

// x0 = sum of the bf16 terms w[k] (low halves), x1 likewise (high halves):
// term 0 = bf16(x) rounded to nearest, each next one the bf16 of the f32
// remainder, which is exact (x less its nearest bf16 keeps x's ulp)
template <int T>
__device__ __forceinline__ void bf16_terms(float x0, float x1, uint32_t (&w)[T]) {
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
    if (k + 1 < T) {
      const float2 f = __bfloat1622float2(b);
      x0 -= f.x;
      x1 -= f.y;
    }
  }
}

// d (16 x 8) += a (16 x 16) b (16 x 8), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where the 16-byte chunk c (of D / 8) of row r lands in a swizzled tile
// of `rows` rows: part c / 8 (64 columns), then the 128-byte swizzle
__device__ __forceinline__ uint32_t sw_chunk(uint32_t tile, int rows, int r, int c) {
  return tile + (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r & 7)) << 4);
}

// What both bf16 bodies share.  Warp w owns q rows 16 w .. 16 w + 15 of the
// block (warpgroup w / 4 rows 64 (w / 4) ..); lane (g, t) = (lane / 4,
// lane % 4).  The logits of a slot and the output O live in the
// accumulator layout of wgmma's f32 D (m16n8k16's C, warp by warp): value
// 4 j + 2 r + e is row g + 8 r and column 8 j + 2 t + e.
template <int D>
struct FlashBf16State {
  static constexpr bool kCrossThreadReads = true;
  static constexpr int kRingAlign = kFa16Align;
  int lane, g, t;
  int row;           // row g of the block: 16 w + g
  int q0, kv0, window;
  int last[2];       // rows g, g + 8: their last key, min(row, kv_len - 1) if causal
  int last_lo;       // the least of the warp's rows' last keys
  float scale2;      // the softmax scale times log2(e)
  uint32_t qs;       // the q tile
  float m[2], l[2];  // rows g and g + 8; m in units of log2
  float o[D / 2];

  __device__ __forceinline__ void init(uint32_t q_tile, int q_first, int kv_first,
                                       int causal, int w, int kv_len, float sc) {
    lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
    row = 16 * (threadIdx.x / 32) + g;
    q0 = q_first;
    kv0 = kv_first;
    window = w;
    scale2 = sc * kLog2e;
    qs = q_tile;
    last_lo = causal ? min(q0 + row - g, kv_len - 1) : kv_len - 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      last[r] = causal ? min(q0 + row + 8 * r, kv_len - 1) : kv_len - 1;
      m[r] = NEG_INF;
      l[r] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  }

  // One step of the online softmax over NB n-blocks of raw logits s (Q
  // K^T): scale (by scale2, so that exp2 gives the exponentials), mask
  // (keys past a row's last key, and the window), fold the quad's max into
  // m, turn s into probabilities, add this lane's share to l and rescale
  // O.  s[4 n + 2 r + e] is KV row kv0 + 8 n + 2 t + e.
  template <int NB>
  __device__ __forceinline__ void softmax(float (&s)[4 * NB]) {
    const int q_hi = q0 + row - g + 15;   // the warp's last row
    const bool mask = kv0 + 8 * NB - 1 > last_lo || (window > 0 && kv0 <= q_hi - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * r + e];
          x *= scale2;
          const int kv = kv0 + 8 * n + 2 * t + e;
          if (mask && (kv > last[r] || (window > 0 && kv <= qi - window))) x = NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - mn);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * r + e];
          x = exp2f(x - mn);
          sum += x;
        }
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * r] *= alpha;
        o[4 * j + 2 * r + 1] *= alpha;
      }
    }
  }

  // The A fragments of P's k16 step ks, term by term: the m16n8k16 A
  // fragment of KV rows 16 ks .. 16 ks + 15 is n-blocks 2 ks and 2 ks + 1
  // of the logits' layout, register r the pair s[8 ks + 2 r], + 1
  __device__ __forceinline__ static void p_frags(const float* s, int ks,
                                                 uint32_t (&p)[kPTerms][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t w[kPTerms];
      bf16_terms(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1], w);
#pragma unroll
      for (int k = 0; k < kPTerms; ++k) p[k][r] = w[k];
    }
  }

  // out: this q head's row q0; the reference's acc / max(l, 1e-30)
  __device__ __forceinline__ void drain(float* out) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.0f / fmaxf(sum, 1e-30f);
      float* dst = out + (row + 8 * r) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
};

// Every strategy but DROP_OFF: kc = 64 KV rows a slot, both products on
// wgmma, each warpgroup its 64 q rows.
template <int D>
struct FlashBf16Body : FlashBf16State<D> {
  static constexpr bool kAsyncProxyReads = true;
  static constexpr int KC = fa16_kc(OVERLAP);
  static constexpr int kPart = KC * 128;     // a 64-column part of K or V

  __device__ __forceinline__ void compute(const char* in, char*) {
    const uint32_t k = smem_u32(in), v = k + (D / 64) * kPart;
    const uint32_t qa = this->qs + (threadIdx.x / 128) * 64 * 128;
    // S = Q K^T: A the q tile, B the K slot, both K-major; m64n64k16, D / 16 steps
    float s[KC / 2];
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) s[i] = 0.0f;
    hold_registers(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<KC, 0>(s, sw128_desc(qa + (ks / 4) * FA_BQ * 128 + 32 * (ks % 4), 16, 1024),
                      sw128_desc(k + (ks / 4) * kPart + 32 * (ks % 4), 16, 1024));
    wgmma_commit();
    wgmma_wait_all();
    hold_registers(s);
    this->template softmax<KC / 8>(s);
    // O += P V: P's bf16 terms from registers, smallest first, V MN-major
    // (LBO: its next 64 columns; the k16 step at +16 rows)
    uint32_t p[KC / 16][kPTerms][4];
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) this->p_frags(s, ks, p[ks]);
    hold_registers(this->o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
      for (int term = kPTerms - 1; term >= 0; --term)
        wgmma_rs<D>(this->o, p[ks][term], sw128_desc(v + ks * 16 * 128, kPart, 1024));
    wgmma_commit();
    wgmma_wait_all();
    hold_registers(this->o);
    this->kv0 += KC;
  }
};

// DROP_OFF: kc = 16 KV rows a slot, taken into registers as the B
// fragments of bf16 mma.sync m16n8k16 (ldmatrix for K, ldmatrix.trans for
// V), so that the slot is free once they are loaded; each warp its 16 q
// rows, whose A fragments it reads from the q tile by ldmatrix.
template <int D>
struct FlashBf16DropOffBody : FlashBf16State<D> {
  static constexpr int KC = fa16_kc(DROP_OFF);
  static constexpr int kPart = KC * 128;
  uint32_t kf[2][D / 16][2];   // K: n-block (KV rows 8 n ..) and k16 step (d 16 ks ..)
  uint32_t vf[D / 8][2];       // V: n-block (d 8 j ..), KV rows 0-7 and 8-15

  __device__ __forceinline__ void load(const char* in) {
    const uint32_t k = smem_u32(in), v = k + (D / 64) * kPart;
    const int i8 = this->lane % 8, mi = this->lane / 8;
    // ldmatrix matrix mi: KV row 8 n + i8, chunk 4 kp + mi (d 32 kp + 8 mi ..)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t x[4];
        ldmatrix_x4(x, sw_chunk(k, KC, 8 * n + i8, 4 * kp + mi));
        kf[n][2 * kp][0] = x[0];
        kf[n][2 * kp][1] = x[1];
        kf[n][2 * kp + 1][0] = x[2];
        kf[n][2 * kp + 1][1] = x[3];
      }
    // ldmatrix.trans matrix mi: KV row 8 (mi % 2) + i8, chunk 2 jp + mi / 2
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t x[4];
      ldmatrix_x4_trans(x, sw_chunk(v, KC, 8 * (mi % 2) + i8, 2 * jp + mi / 2));
      vf[2 * jp][0] = x[0];
      vf[2 * jp][1] = x[1];
      vf[2 * jp + 1][0] = x[2];
      vf[2 * jp + 1][1] = x[3];
    }
  }
  // Q K^T of the slot's two n-blocks, the even and the odd k16 steps into
  // two sums (two chains of dependent mma steps overlap), then P V
  __device__ __forceinline__ void store(char*) {
    float s[8] = {}, odd[8] = {};
    const int qr = 16 * (threadIdx.x / 32) + (this->lane & 15);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, sw_chunk(this->qs, FA_BQ, qr, 2 * ks + (this->lane >> 4)));
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma_bf16((ks % 2 ? odd : s) + 4 * n, a, kf[n][ks][0], kf[n][ks][1]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] += odd[i];
    this->template softmax<2>(s);
    uint32_t p[kPTerms][4];
    this->p_frags(s, 0, p);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int term = kPTerms - 1; term >= 0; --term)
        mma_bf16(this->o + 4 * j, p[term], vf[j][0], vf[j][1]);
    this->kv0 += KC;
  }
};

template <int D, int S, int A, int O>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const char* q, const char* k, const char* v, float* o, int h, int kvh,
                  int s_len, int kv_len, int bk, int causal, int window, float scale,
                  int depth, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap) {
  constexpr int kc = fa16_kc(S), kParts = D / 64;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;   // longest KV ranges first
  const long long head = static_cast<long long>(bh / h) * kvh + (bh % h) / (h / kvh);
  int hi = s_len / bk, lo = 0;
  if (causal) hi = min((q0 + FA_BQ + bk - 1) / bk, hi);
  if (window > 0) lo = max((q0 - window + 1) / bk, 0);   // a negative numerator clamps to 0
  hi = min(hi, (kv_len + bk - 1) / bk);
  hi = max(hi, lo);   // a window wholly past kv_len: no tile, an output row of 0

  // the q tile in bf16, unscaled: D / 64 parts of 128 rows x 128 bytes in
  // the 128-byte swizzle, after the ring (whose base run_pipeline rounds up
  // to kFa16Align as here)
  char* base = smem + (kFa16Align - smem_u32(smem) % kFa16Align) % kFa16Align;
  const uint32_t qs = smem_u32(base + fa16_q_offset(S, depth, D));
  const char* qg = q + (static_cast<long long>(bh) * s_len + q0) * D * 2;
  for (int e = threadIdx.x; e < FA_BQ * D / 8; e += kThreads) {
    const int r = e / (D / 8), c = e % (D / 8);
    const uint4 x = ld16(qg + (r * D + 8 * c) * 2);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(sw_chunk(qs, FA_BQ, r, c)), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
  }
  fence_proxy_async();   // wgmma reads the q tile through the async proxy

  // K's parts, then V's: rows of 128 bytes (64 columns) at row pitch 2 D
  const long long first = (head * s_len + static_cast<long long>(lo) * bk) * D * 2;
  Operand op[2 * kParts];
#pragma unroll
  for (int p = 0; p < 2 * kParts; ++p) {
    op[p] = Operand{(p < kParts ? k : v) + first + 128 * (p % kParts), 2LL * D, 2LL * kc * D,
                    kc, 128, 128};
    op[p].swizzle128 = true;
    if constexpr (S == TMA) {   // boxes of 64 columns x kc rows at (64 part, row)
      op[p].map = p < kParts ? &kmap : &vmap;
      op[p].x0 = 64 * (p % kParts);
      op[p].y0 = static_cast<int>(head * s_len) + lo * bk;
      op[p].dy = kc;
    }
  }
  std::conditional_t<S == DROP_OFF, FlashBf16DropOffBody<D>, FlashBf16Body<D>> body;
  body.init(qs, q0, lo * bk, causal, window, kv_len, scale);
  run_pipeline<S, A, O>(body, op, op[0], (hi - lo) * (bk / kc), depth);
  body.drain(o + (static_cast<long long>(bh) * s_len + q0) * D);
}

template <int D>
struct FlashBf16Launch {
  static constexpr bool kTileOutput = false;
  const char *q, *k, *v;
  float* o;
  int bh, h, kvh, s_len, kv_len, bk, causal, window;
  float scale;
  int depth, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (bk % fa16_kc(S) || smem < fa16_smem(S, depth, D)) return kNotBuilt;
    CUtensorMap kmap{}, vmap{};
    cudaError_t e = cudaSuccess;
    if constexpr (S == TMA) {   // K and V as (B KVH S) rows of D, boxes 64 x kc
      const uint64_t rows = static_cast<uint64_t>(bh / h) * kvh * s_len;
      e = encode_tensor_map_2d(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, D, rows, 2ull * D,
                               64, fa16_kc(S), CU_TENSOR_MAP_SWIZZLE_128B);
      if (e == cudaSuccess)
        e = encode_tensor_map_2d(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, D, rows,
                                 2ull * D, 64, fa16_kc(S), CU_TENSOR_MAP_SWIZZLE_128B);
      if (e != cudaSuccess) return e;
    }
    auto kernel = flash_bf16_kernel<D, S, A, O>;
    if ((e = ensure_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<dim3(bh, s_len / FA_BQ), kThreads, smem, stream>>>(
        q, k, v, o, h, kvh, s_len, kv_len, bk, causal, window, scale, depth, kmap, vmap);
    return cudaGetLastError();
  }
};

template <int D>
using FlashF32Launch = FlashLaunch<D, 4>;

// The launchers' shared body: L<D> launches head dim D
template <template <int> class L>
int flash_launch(int device, int strategy, int ahead, int depth, const void* q, const void* k,
                 const void* v, void* o, int bh, int h, int kvh, int s, int kv_len, int d,
                 int bk, int causal, int window, float scale, int smem, void* stream) {
  if (bh < 1 || h < 1 || kvh < 1 || h % kvh || bh % h || s < 1 || s % FA_BQ || bk < 1 ||
      s % bk || kv_len < 1 || kv_len > s || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || static_cast<long long>(bh / h) * kvh * s >= (1LL << 31))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const char *qc = static_cast<const char*>(q), *kc = static_cast<const char*>(k),
             *vc = static_cast<const char*>(v);
  float* of = static_cast<float*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return dispatch(strategy, ahead, 0,
                    L<64>{qc, kc, vc, of, bh, h, kvh, s, kv_len, bk, causal, window, scale,
                          depth, smem, st});
  if (d == 128)
    return dispatch(strategy, ahead, 0,
                    L<128>{qc, kc, vc, of, bh, h, kvh, s, kv_len, bk, causal, window, scale,
                           depth, smem, st});
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
// window (> 0: a sliding window) mask as the reference, and every key at
// kv_len and past (1 <= kv_len <= s) is masked for every query.  One launch on
// `stream`, no synchronisation; returns a cudaError_t.
extern "C" int flash_attention_launch(int device, int strategy, int ahead, int depth,
                                      const void* q, const void* k, const void* v,
                                      void* o, int bh, int h, int kvh, int s, int kv_len,
                                      int d, int bk, int causal, int window, float scale,
                                      int smem, void* stream) {
  return rt::flash_launch<rt::FlashF32Launch>(device, strategy, ahead, depth, q, k, v, o, bh,
                                              h, kvh, s, kv_len, d, bk, causal, window, scale,
                                              smem, stream);
}

// The same with q, k and v in bf16 (o stays f32)
extern "C" int flash_attention_bf16_launch(int device, int strategy, int ahead, int depth,
                                           const void* q, const void* k, const void* v,
                                           void* o, int bh, int h, int kvh, int s,
                                           int kv_len, int d, int bk, int causal, int window,
                                           float scale, int smem, void* stream) {
  return rt::flash_launch<rt::FlashBf16Launch>(device, strategy, ahead, depth, q, k, v, o,
                                               bh, h, kvh, s, kv_len, d, bk, causal, window,
                                               scale, smem, stream);
}
