// Flash attention's backward pass for Hopper: dQ, dK and dV of the forward
// in csrc/flash_attention.cu (causal and/or sliding-window online-softmax
// attention with grouped KV heads and a key count), f32 or bf16 in, the
// gradients in the input's type.  Two designs, one a type, each three
// kernels in one launcher call.
//
// Replaces no Pallas kernel: src/repro/kernels/flash_attention.py
// (flash_attention_pallas, line 107) has no backward, because JAX trains by
// differentiating jnp.  The port runs prefill attention on the forward
// kernel, so training on the card needs this one.  kernels/flash_attention.py
// (flash_attention_bwd_cuda) launches it and flash_attention_bwd_plain is its
// plain version, step for step.
//
// What both designs compute.  The forward writes no log-sum-exp, so:
//   1. prep, a block of query rows of one q head: Delta = rowsum(dO o O) and
//      each row's softmax statistics over the forward's key tiles, m (the
//      running max, starting at NEG_INF = -1e30) and 1 / l (l the sum of
//      exp(s - m)), with the forward's masking: masked logits are NEG_INF,
//      not -inf, so a row whose every key is masked gets the forward's
//      uniform weights over the tiles it visits.
//   2. dK/dV, a block of key rows of one kv head: for each q head of the kv
//      head's group and each query block whose tiles hold the key block
//      (the inverse of kv_range, found by walking the query blocks), it
//      recomputes P = exp(scale Q K^T - m) / l, then dV += P^T dO,
//      dP = dO V^T, dS = P o (dP - Delta) (0 where masked), dK += dS^T Q;
//      dK is scaled once at the end.
//   3. dQ, a block of query rows of one q head: dQ = scale sum dS K over the
//      row block's key tiles.
// No atomics: a kv head's group is summed in a fixed order (q heads, then
// query blocks, ascending), so a run gives the same bits every time.
// The key tiles a query block visits are the forward's: kv_range in units
// of the reference's bk = 128 for the 128-row query block that holds it
// (kBq), then cut to the key count kv_len.  Every 64 x 64 pair inside those
// tiles is computed, none skipped, so the uniform rows above match the
// forward exactly.  Bound: operations, the function's five products of the
// query block by key block pairs the mask keeps (Q K^T, dP = dO V^T, dV,
// dK, dQ); each design recomputes Q K^T in all three kernels and dO V^T in
// the last two, the price of no atomics and a fixed summation order.
//
// The f32 design (fa_bwd_prep<D>, fa_bwd_dkdv<D>, fa_bwd_dq<D>; namespace
// fa_bwd, after the bf16 one): every product on the tensor cores as 3xTF32
// mma.sync m16n8k8 (csrc/mma_tf32.cuh: lo hi, hi lo, hi hi, each exact in
// the f32 accumulator), f32 tiles in shared memory split into hi and lo as
// each fragment is loaded.  On FFMA the eight products cannot run below
// 12.32 ms at the h100 cell (824.6 GFLOP at 66.9 TFLOP/s); in 3xTF32 they
// are 3 x 824.6 GFLOP of tensor work, 5.00 ms at the 495 TFLOP/s
// data-sheet rate and 7.81 ms at the 316.7 TFLOP/s mma.sync reached
// (chip_smoke.py's probe, NVIDIA H100 80GB HBM3 at 700 W; PERF.md has the
// times).
//   Why mma.sync and not wgmma: wgmma has transpose bits for 16-bit types
//   only, so its TF32 operands in shared memory are K-major, and dV += P^T
//   dO, dK += dS^T Q and dQ += dS K read their B MN-major (the bf16
//   design's imm-trans-b = 1); prep would have to write transposed copies
//   of Q, dO and K.  mma.sync loads a fragment from any layout.
//   Split: split_rz (hi = x's top 19 bits, one logic operation; lo = x -
//   hi), not the forward's split (hi rounded to nearest, two integer
//   operations): the split is the inner loops' main work beside mma.sync,
//   and split_rz ran the cell 5% faster (bench.ab on an NVIDIA H100 80GB
//   HBM3) for a CPU-replay error of 9.3e-7 against 3.2e-7 (both far inside
//   the 2e-5 bound).
//   Sums: each product_cols step sums from zero and is added to the
//   running f32 sum (below); chained across a dK/dV walk in one mma
//   accumulator, the tensor core's accumulation, which is not rounded to
//   nearest, drifted to 8.8e-5 relative l2 at the cell (on the H100).
//   Blocks.  256 threads, 8 warps, over 64-row blocks of keys (dK/dV) or
//   queries (dQ), 128-row ones (prep); f32 tiles with rows padded by 4
//   floats; the streamed ones through cp.async slots (the next copies
//   issued before this step's products).
//   Products.  product_rows, C = A B^T with both operands' rows along d
//   (S = Q K^T, dP = dO V^T and their transposes): both fragments by
//   ldmatrix.x4 of the f32 data as b16 pairs.  product_cols, acc += C' Y
//   with C' product_rows results read in place as A fragments: n-block j
//   of an accumulator is k-step j with its columns 2 t, 2 t + 1 as k slots
//   t, t + 4, so Y's B rows are 8 j + 2 t and + 1 (tests/test_torch_flash_
//   backward_tf32_replay.py pins the mapping), each float4 of a Y row
//   feeding four n-blocks (output columns 32 c + 4 g + i).
//   Statistics: stats[0] = m (in units of log2: the logits are scaled by
//   scale log2(e) after Q K^T and P = exp2(x - m) / l), stats[1] = 1 / l,
//   stats[2] = Delta, each (bh, s) f32.
//   prep (128 query rows, the forward's block): q resident, K through
//     three slots; warp w's 16 rows x 64 keys a block, the running max and
//     each lane's share of l.
//   dK/dV (keys the M rows, fa_bwd16::DkdvWalk's walk): K and V resident, q,
//     dO and the rows' stats through two slots.  Warp (mw, nw) makes S^T =
//     K Q^T and dP^T = V dO^T for its 16 keys and half nw of the step's 64
//     queries, P^T and dS^T on the accumulators; the nw = 0 warps then sum
//     dV += P^T dO and the nw = 1 warps dK += dS^T Q over all 64 queries,
//     each handed the other half's P^T or dS^T through 16 KB of shared
//     memory.  A thread holds one D-wide sum (D / 4 registers): with both
//     dK and dV a thread (128 registers at D = 128) ptxas spilled at 255.
//   dQ (64 query rows): q, dO and the stats resident, K and V through two
//     slots; warp (mw, nw) makes S and dP for its 16 rows and half nw of a
//     64-key block, dS, and dQ += dS K over those 32 keys; the halves are
//     added once at the end.
//   Grid order as the bf16 design's: dK/dV key block 0 first, prep and dQ
//   from the last query block down.
//
// The bf16 design (fa_bwd16_rows<mode, D> for prep and dQ, fa_bwd16_dkdv;
// namespace fa_bwd16): every product on bf16 wgmma (m64nNk16, f32
// accumulators), every operand loaded by TMA.
//   Terms.  Q, K and V are bf16 and each product of two bf16 values is exact
//   in the f32 accumulator.  dO (the gradient of the forward's f32 output),
//   P and dS are f32 values, each split into kTerms = 2 bf16 terms (hi =
//   bf16(x), lo = bf16(x - hi), the remainder exact in f32: 16 of x's 24
//   significand bits), and a product of two split operands keeps hi hi,
//   hi lo and lo hi.  The CPU replay (tests/test_torch_flash_backward_
//   replay.py) gives, relative l2 of (dQ, dK, dV) against the float64 plain
//   backward on bf16 inputs at s = 1024, d = 128, 4 heads, causal, with (P,
//   dO, dS) in (1, 1, 1) terms 3.01e-3, 2.98e-3, 2.87e-3 (past the card's
//   3e-3 at s = 256, 4 heads over 2); (1, 2, 2) 1.66e-3, 1.66e-3, 2.35e-3;
//   (2, 2, 1) 2.36e-3, 2.34e-3, 1.65e-3; (2, 2, 2) 1.66e-3, 1.66e-3,
//   1.65e-3, the gradients' own bf16 rounding (three terms: the same).  So
//   (2, 2, 2), in units of one bf16 product: Q K^T 1, dO V^T 2 (V dO_lo,
//   then V dO_hi), dV 3 (P_lo dO_hi, P_hi dO_lo, P_hi dO_hi), dK 2 and dQ 2
//   (dS_lo, then dS_hi), and Q K^T once more in each of the three kernels
//   and twice in dK/dV (below): 15 units, 103.1 GFLOP each at the h100
//   cell, a floor of 1.563 ms at 989 TFLOP/s (the function's own five
//   products take 0.5211 ms).  Each sum is f32.
//   Scale and mask as the forward's bf16 design: the logits are scaled after
//   Q K^T by scale log2(e) in f32, so m is in units of log2 and P =
//   exp2(x - m) / l; masked logits NEG_INF, dS 0 where masked.
//   Layout.  Every tile is bf16 in the 128-byte swizzle with no pad: D / 64
//   parts of R rows x 128 bytes (chunk c of row r at r * 128 + ((c ^ (r &
//   7)) << 4)), each on 1,024 bytes, loaded as TMA boxes of 64 columns x 64
//   rows from 2-D tensor maps over q (B H S, D), k, v (B KVH S, D) and dO's
//   terms (2 B H S, D: the hi plane, then the lo plane).  A K-major operand
//   (the A of every ss-form product, and the B of Q K^T, K Q^T, dO V^T and
//   V dO^T) steps 32 bytes a k16 step inside a part; an MN-major B (dO, Q
//   and K as the B of dV, dK and dQ: imm-trans-b = 1) steps 16 rows, its
//   next 64 columns one part on.
//   Blocks.  384 threads: warpgroup 0 the producer (its thread 0 issues
//   every load), warpgroups 1 and 2 two consumers, one block an SM, a ring
//   of kDepth slots with full (expect-tx) and empty (one arrival a consumer
//   warpgroup) mbarriers, as matmul.cu's batched kernel; a wait past two
//   seconds traps.  At 384 threads ptxas allocates every thread within 168
//   registers whatever setmaxnreg grants (its spills did not move between
//   setmaxnreg 24/240, 40/232 and none; PERF.md §6), so the kernels
//   run no setmaxnreg and are written to fit 168: no warpgroup holds more
//   than one D-wide accumulator.  The stats scratch
//   is [bh][s / 64][m, 1 / l, Delta][64] f32, then dO's hi and lo planes
//   (bh s x d bf16 each).
//   prep (fa_bwd16_rows<kPrep>), a block per 128 query rows of a q head
//     (the forward's block): the consumers first write Delta and dO's terms
//     for the block's rows (f32 loads of dO and O), then S = Q K^T over the
//     key tiles in 64-row blocks through the ring (Q resident, K a slot),
//     the online max and each lane's share of l on the accumulators, a
//     slot freed as soon as S is in registers.
//   dK/dV (fa_bwd16_dkdv), a block per 64 keys of a kv head (half of one
//   of the forward's key tiles): K and V resident; the walk's 64-row query
//   blocks stream through the ring (Q, dO's two terms and the rows' m,
//   1 / l, Delta: 49 KB a slot at D = 128, three slots).  Keys are wgmma's
//   M rows.  Consumer 1 sums dV: S^T = K Q^T (ss-form, B K-major), then P^T
//   from the accumulators straight into wgmma_rs's A fragments (n-blocks 2
//   ks and 2 ks + 1 of the m64n64 layout are k16 step ks) for dV += P^T dO
//   (B MN-major).  Consumer 2 sums dK: S^T and dP^T = V dO^T, then dS^T
//   into the A fragments of dK += dS^T Q.  dK and dV take D / 2 f32
//   registers a thread each, S^T and dP^T 32: both in one warpgroup need
//   245 registers (ptxas at 256 threads), past 168.
//   dQ (fa_bwd16_rows<kDq>), a block per 128 query rows: Q and dO's terms
//     resident, each consumer its 64 rows; K and V in 64-row blocks
//     through the ring.  S = Q K^T and dP = dO V^T ss-form, dS from the
//     accumulators into wgmma_rs's A for dQ += dS K (B MN-major).
//   Order.  Causal blocks longest first: dK/dV's grid is (kv heads, key
//   blocks) with key block 0 (every query block) dispatched first, prep's
//   and dQ's (q heads, query blocks) from the last query block down.  The
//   products of a slot issue as one wgmma group, waited for before the
//   slot is freed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_pipeline.cuh"
#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace fa_bwd {

constexpr int kBlk = 64;        // rows of a query block and of a key block
constexpr int kThreads = 256;   // the f32 design's 8 warps
constexpr int kBq = 128;        // the forward's query block and key tile (bq = bk)
constexpr float kNegInf = -1e30f;

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

}  // namespace fa_bwd

namespace fa_bwd16 {

using namespace rt;

constexpr int kBlk = 64;           // a consumer warpgroup's rows; a query or key block
constexpr int kBq = fa_bwd::kBq;   // the forward's query block and key tile
constexpr int kThreads16 = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int kDepth = 3;          // ring slots
constexpr int kTerms = 2;          // bf16 terms of dO, P and dS
constexpr int kAlign = 1024;       // SWIZZLE_128B atoms
constexpr int kStatBytes = 3 * kBlk * 4;   // m, 1 / l, Delta of 64 rows
constexpr float kNegInf = fa_bwd::kNegInf;
constexpr float kLog2e = 1.44269504088896340736f;

// bytes of a swizzled tile of R rows x D bf16: D / 64 parts of R x 128
template <int R, int D>
constexpr int tile_bytes() {
  return D / 64 * R * 128;
}

// stats: m (which 0), 1 / l (1) and Delta (2) of row `row` of q head bh
__device__ __forceinline__ size_t stat_at(int bh, int s, int row, int which) {
  return ((static_cast<size_t>(bh) * (s / kBlk) + row / kBlk) * 3 + which) * kBlk + row % kBlk;
}

// Does the 64 x 64 block of queries q0.. and keys k0.. hold a masked pair?
__device__ __forceinline__ bool needs_mask(int q0, int k0, int causal, int window,
                                           int kv_len) {
  return (causal && k0 + kBlk - 1 > q0) || (window > 0 && k0 <= q0 + kBlk - 1 - window) ||
         k0 + kBlk > kv_len;
}

// w[k] = the bf16 pair of term k of (x0, x1): term 0 = bf16(x) rounded to
// nearest, term 1 the bf16 of the exact f32 remainder
__device__ __forceinline__ void split_terms(float x0, float x1, uint32_t (&w)[kTerms]) {
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
    const float2 f = __bfloat1622float2(b);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// The A fragments of the k16 steps of an m64n64 accumulator, term by term:
// step ks (columns 16 ks .. 16 ks + 15) is n-blocks 2 ks and 2 ks + 1,
// register r the pair acc[8 ks + 2 r], + 1
__device__ __forceinline__ void a_frags(const float (&acc)[32], uint32_t (&a)[4][kTerms][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t w[kTerms];
      split_terms(acc[8 * ks + 2 * r], acc[8 * ks + 2 * r + 1], w);
#pragma unroll
      for (int k = 0; k < kTerms; ++k) a[ks][k][r] = w[k];
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// A K-major operand at k16 step ks (columns 16 ks ..): `tile` a row of a
// swizzled tile of `rows` rows (its parts that far apart)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int ks) {
  return sw128_desc(tile + (ks / 4) * rows * 128 + 32 * (ks % 4), 16, 1024);
}
// MN-major B of a 64-row tile at k16 step ks (rows 16 ks ..)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int ks) {
  return sw128_desc(tile + ks * 16 * 128, kBlk * 128, 1024);
}

// rows rows .. rows + 63 of a tensor map into a swizzled tile of `tile_rows`
// rows at dst: one box a part
template <int D>
__device__ __forceinline__ void load_rows(char* dst, int tile_rows, const CUtensorMap* map,
                                          int row, uint64_t* bar) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_2d(dst + p * tile_rows * 128, map, 64 * p, row, bar);
}

// This consumer thread's place in its warpgroup's m64 accumulators.
struct Lane {
  int wg;   // consumer warpgroup: rows 64 wg .. of the block
  int row;  // row g of the warpgroup's 64 (16 w + g); accumulator rows row, row + 8
  int t;    // the quad lane: accumulator columns 8 j + 2 t + e
  __device__ __forceinline__ Lane()
      : wg(threadIdx.x / 128 - 1), row(16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4),
        t(threadIdx.x % 4) {}
};

// A walk's place in the ring (the producer and each consumer keep one):
// slot and parity of the round.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == kDepth) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------------- prep, dQ --

enum Mode : int { kPrep = 0, kDq = 1 };

template <int M, int D>
struct RowsLayout {
  static constexpr int kQ = tile_bytes<kBq, D>();          // 128 rows: q, dO hi, dO lo
  static constexpr int kRes = (M == kDq ? 3 : 1) * kQ;     // the resident tiles
  static constexpr int kKv = tile_bytes<kBlk, D>();        // 64 rows of K or V
  static constexpr int kSlot = (M == kDq ? 2 : 1) * kKv;   // K, then V (dQ)
  static constexpr int kBars = kRes + kDepth * kSlot;      // full, empty, resident
  static constexpr int kSmem = kAlign + kBars + (2 * kDepth + 1) * 8;
};

// prep (M = kPrep): Delta, dO's terms and each row's (m, 1 / l); dQ (M =
// kDq): dq.  Block (x, y): q head x of the (B H) flattened heads, query
// block gridDim.y - 1 - y of 128 rows.
template <int M, int D>
__global__ void __launch_bounds__(kThreads16, 1)
    fa_bwd16_rows(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap dmap, const float* __restrict__ o,
                  const float* __restrict__ dout, float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dterms, __nv_bfloat16* __restrict__ dq, int h,
                  int kvh, int s, int kv_len, int causal, int window, float scale) {
  using L = RowsLayout<M, D>;
  char* base = smem + (kAlign - smem_u32(smem) % kAlign) % kAlign;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kDepth;
  uint64_t* res = empty + kDepth;
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int head = (bh / h) * kvh + (bh % h) / (h / kvh);
  const int rows_q = gridDim.x * s;   // rows of q: B H S
  int lo, hi;
  fa_bwd::kv_tiles(q0, s, causal, window, kv_len, &lo, &hi);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDepth; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);
    }
    mbar_init(res, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    if (threadIdx.x != 0) return;
    const int row = bh * s + q0;
    mbar_expect_tx(res, L::kRes);
#pragma unroll
    for (int i = 0; i < (M == kDq ? 3 : 1); ++i)   // q, then dO's hi and lo planes
#pragma unroll
      for (int r = 0; r < 2; ++r)
        load_rows<D>(base + i * L::kQ + r * kBlk * 128, kBq, i ? &dmap : &qmap,
                     (i == 2 ? rows_q : 0) + row + r * kBlk, res);
    Ring ring;
    for (int kb = 2 * lo; kb < 2 * hi; ++kb, ring.next()) {
      mbar_wait_bounded(empty + ring.slot, ring.phase ^ 1);
      char* slot = base + L::kRes + ring.slot * L::kSlot;
      mbar_expect_tx(full + ring.slot, L::kSlot);
      const int krow = head * s + kb * kBlk;
      load_rows<D>(slot, kBlk, &kmap, krow, full + ring.slot);
      if constexpr (M == kDq) load_rows<D>(slot + L::kKv, kBlk, &vmap, krow, full + ring.slot);
    }
    return;
  }
  const Lane ln;
  const float scale2 = scale * kLog2e;
  const int rq0 = q0 + kBlk * ln.wg;   // this warpgroup's first query row
  if constexpr (M == kPrep) {
    // Delta = rowsum(dO o O) in f32 and dO's two bf16 terms: a warp a row
    const int warp = threadIdx.x / 32 - 4, lane = threadIdx.x % 32;
    for (int r = warp; r < kBq; r += 8) {
      const size_t row = static_cast<size_t>(bh) * s + q0 + r;
      float acc = 0.0f;
      for (int c = 4 * lane; c < D; c += 128) {
        const float4 x = *reinterpret_cast<const float4*>(dout + row * D + c);
        const float4 y = *reinterpret_cast<const float4*>(o + row * D + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
        uint32_t a[kTerms], b[kTerms];
        split_terms(x.x, x.y, a);
        split_terms(x.z, x.w, b);
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          *reinterpret_cast<uint2*>(dterms + k * static_cast<size_t>(rows_q) * D + row * D + c) =
              make_uint2(a[k], b[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) stats[stat_at(bh, s, q0 + r, 2)] = acc;
    }
  }
  // rows row, row + 8: prep's running max and this lane's share of l; dQ's m, 1 / l
  // (in l) and Delta
  float m[2], l[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (M == kPrep) {
      m[r] = kNegInf;
      l[r] = 0.0f;
    } else {
      const int qi = rq0 + ln.row + 8 * r;
      m[r] = stats[stat_at(bh, s, qi, 0)];
      l[r] = stats[stat_at(bh, s, qi, 1)];
      dl[r] = stats[stat_at(bh, s, qi, 2)];
    }
  }
  float dqa[M == kDq ? D / 2 : 1];
  zero(dqa);
  const uint32_t qa = smem_u32(base) + kBlk * ln.wg * 128;   // this warpgroup's q rows
  mbar_wait_bounded(res, 0);
  Ring ring;
  for (int kb = 2 * lo; kb < 2 * hi; ++kb, ring.next()) {
    mbar_wait_bounded(full + ring.slot, ring.phase);
    const uint32_t kt = smem_u32(base + L::kRes + ring.slot * L::kSlot), vt = kt + L::kKv;
    // S = Q K^T, and in dQ dP = dO V^T (dO's lo term, then hi)
    float sa[32], pa[32];
    zero(sa);
    hold_registers(sa);
    if constexpr (M == kDq) {
      zero(pa);
      hold_registers(pa);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(sa, kmajor(qa, kBq, ks), kmajor(kt, kBlk, ks));
    if constexpr (M == kDq) {
#pragma unroll
      for (int term = kTerms - 1; term >= 0; --term)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<64, 0>(pa, kmajor(qa + (1 + term) * L::kQ, kBq, ks), kmajor(vt, kBlk, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_registers(sa);
    if constexpr (M == kDq) hold_registers(pa);
    const int k0 = kb * kBlk;
    const bool mask = needs_mask(rq0, k0, causal, window, kv_len);
    if constexpr (M == kPrep) {
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.slot);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = rq0 + ln.row + 8 * r;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sa[4 * j + 2 * r + e];
            x *= scale2;
            if (mask && !fa_bwd::visible(qi, k0 + 8 * j + 2 * ln.t + e, causal, window, kv_len))
              x = kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += exp2f(sa[4 * j + 2 * r + e] - mn);
        l[r] = l[r] * exp2f(m[r] - mn) + sum;
        m[r] = mn;
      }
    } else {
      // dS = P o (dP - Delta), 0 where masked, into pa
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = rq0 + ln.row + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            const bool keep =
                !mask || fa_bwd::visible(qi, k0 + 8 * j + 2 * ln.t + e, causal, window, kv_len);
            const float p = exp2f((keep ? sa[i] * scale2 : kNegInf) - m[r]) * l[r];
            pa[i] = keep ? p * (pa[i] - dl[r]) : 0.0f;
          }
      }
      uint32_t ds[4][kTerms][4];
      a_frags(pa, ds);
      // dQ += dS K: K MN-major, dS's lo term, then hi
      hold_registers(dqa);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int term = kTerms - 1; term >= 0; --term) wgmma_rs<D>(dqa, ds[ks][term], mnmajor(kt, ks));
      wgmma_commit();
      wgmma_wait_all();
      hold_registers(dqa);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.slot);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = rq0 + ln.row + 8 * r;
    if constexpr (M == kPrep) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (ln.t == 0) {
        stats[stat_at(bh, s, qi, 0)] = m[r];
        stats[stat_at(bh, s, qi, 1)] = sum > 0.0f ? 1.0f / sum : 0.0f;
      }
    } else {
      __nv_bfloat16* dst = dq + (static_cast<size_t>(bh) * s + qi) * D + 2 * ln.t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
    }
  }
}

// -------------------------------------------------------------------- dK/dV --

template <int D>
struct DkdvLayout {
  static constexpr int kKv = tile_bytes<kBlk, D>();   // 64 keys of K, then of V
  static constexpr int kQ = tile_bytes<kBlk, D>();    // 64 rows: q, dO hi, dO lo
  static constexpr int kSlot = 3 * kQ + kAlign;       // and the rows' stats
  static constexpr int kBars = 2 * kKv + kDepth * kSlot;
  static constexpr int kSmem = kAlign + kBars + (2 * kDepth + 1) * 8;
};

// The dK/dV walk of key tile `tile` (the forward's, 128 keys) of kv head g
// of batch b: each q head of the group, each query block whose key tiles
// hold the tile (a run of blocks: both ends of kv_tiles grow with the
// block), both 64-row halves; step i is q head bh(i), rows q0(i) ..
struct DkdvWalk {
  int bh0, first, blocks, steps;
  __device__ __forceinline__ DkdvWalk(int tile, int b, int g, int h, int kvh, int s,
                                      int kv_len, int causal, int window) {
    first = s / kBq;
    int last = -1;
    for (int qb = 0; qb < s / kBq; ++qb) {
      int lo, hi;
      fa_bwd::kv_tiles(qb * kBq, s, causal, window, kv_len, &lo, &hi);
      if (lo <= tile && tile < hi) {
        first = min(first, qb);
        last = qb;
      }
    }
    blocks = max(last - first + 1, 0);
    bh0 = b * h + g * (h / kvh);
    steps = h / kvh * blocks * 2;
  }
  __device__ __forceinline__ int bh(int i) const { return bh0 + i / (2 * blocks); }
  __device__ __forceinline__ int q0(int i) const {
    return (first + i % (2 * blocks) / 2) * kBq + i % 2 * kBlk;
  }
};

enum Role : int { kDv = 0, kDk = 1 };

// A consumer warpgroup's walk: R = kDv sums dV += P^T dO (P_lo dO_hi, P_hi
// dO_lo, P_hi dO_hi), R = kDk dK += dS^T Q (dS's lo term, then hi), each
// over the block's 64 keys (wgmma's rows), into acc; both recompute S^T =
// K Q^T, kDk also dP^T = V dO^T (dO's lo term, then hi).
template <int R, int D>
__device__ __forceinline__ void dkdv_consume(float (&acc)[D / 2], char* base, uint64_t* full,
                                             uint64_t* empty, const DkdvWalk& walk, int k0,
                                             int causal, int window, int kv_len,
                                             float scale2) {
  using L = DkdvLayout<D>;
  const Lane ln;
  const uint32_t ka = smem_u32(base), va = ka + L::kKv;
  Ring ring;
  for (int i = 0; i < walk.steps; ++i, ring.next()) {
    mbar_wait_bounded(full + ring.slot, ring.phase);
    const int q0 = walk.q0(i);
    char* slot = base + 2 * L::kKv + ring.slot * L::kSlot;
    const uint32_t qs = smem_u32(slot), dh = qs + L::kQ, dlo = qs + 2 * L::kQ;
    float sa[32], pa[32];
    zero(sa);
    hold_registers(sa);
    if constexpr (R == kDk) {
      zero(pa);
      hold_registers(pa);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(sa, kmajor(ka, kBlk, ks), kmajor(qs, kBlk, ks));
    if constexpr (R == kDk) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(pa, kmajor(va, kBlk, ks), kmajor(dlo, kBlk, ks));
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(pa, kmajor(va, kBlk, ks), kmajor(dh, kBlk, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_registers(sa);
    if constexpr (R == kDk) hold_registers(pa);
    // P^T = exp2(x - m) / l by query column; kDv splits it into its terms as
    // it is made (register 2 (j % 2) + r of k16 step j / 2: a_frags' order),
    // kDk makes dS^T = P^T o (dP^T - Delta) in pa
    const float* st = reinterpret_cast<const float*>(slot + 3 * L::kQ);
    const bool mask = needs_mask(q0, k0, causal, window, kv_len);
    uint32_t a[4][kTerms][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * ln.t;
      const float2 mq = *reinterpret_cast<const float2*>(st + c);
      const float2 rl = *reinterpret_cast<const float2*>(st + kBlk + c);
      float2 dl;
      if constexpr (R == kDk) dl = *reinterpret_cast<const float2*>(st + 2 * kBlk + c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 4 * j + 2 * r + e;
          const bool keep = !mask || fa_bwd::visible(q0 + c + e, k0 + ln.row + 8 * r, causal,
                                                     window, kv_len);
          p[e] = exp2f((keep ? sa[n] * scale2 : kNegInf) - (e ? mq.y : mq.x)) *
                 (e ? rl.y : rl.x);
          if constexpr (R == kDk) pa[n] = keep ? p[e] * (pa[n] - (e ? dl.y : dl.x)) : 0.0f;
        }
        if constexpr (R == kDv) {
          uint32_t w[kTerms];
          split_terms(p[0], p[1], w);
#pragma unroll
          for (int k = 0; k < kTerms; ++k) a[j / 2][k][2 * (j % 2) + r] = w[k];
        }
      }
    }
    if constexpr (R == kDk) a_frags(pa, a);
    hold_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (R == kDv) {
        wgmma_rs<D>(acc, a[ks][1], mnmajor(dh, ks));
        wgmma_rs<D>(acc, a[ks][0], mnmajor(dlo, ks));
        wgmma_rs<D>(acc, a[ks][0], mnmajor(dh, ks));
      } else {
        wgmma_rs<D>(acc, a[ks][1], mnmajor(qs, ks));
        wgmma_rs<D>(acc, a[ks][0], mnmajor(qs, ks));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_registers(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.slot);
  }
}

// Block (x, y): kv head x of the (B KVH) flattened heads, keys 64 y ..;
// consumer warpgroup 1 sums dV, 2 dK.
template <int D>
__global__ void __launch_bounds__(kThreads16, 1)
    fa_bwd16_dkdv(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap dmap, const float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int h,
                  int kvh, int s, int kv_len, int causal, int window, float scale) {
  using L = DkdvLayout<D>;
  char* base = smem + (kAlign - smem_u32(smem) % kAlign) % kAlign;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kDepth;
  uint64_t* kv = empty + kDepth;
  const int kvi = blockIdx.x, k0 = blockIdx.y * kBlk;
  const int rows_q = gridDim.x / kvh * h * s;   // rows of q: B H S
  const DkdvWalk walk(k0 / kBq, kvi / kvh, kvi % kvh, h, kvh, s, kv_len, causal, window);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDepth; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);
    }
    mbar_init(kv, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    if (threadIdx.x != 0) return;
    mbar_expect_tx(kv, 2 * L::kKv);
    load_rows<D>(base, kBlk, &kmap, kvi * s + k0, kv);
    load_rows<D>(base + L::kKv, kBlk, &vmap, kvi * s + k0, kv);
    Ring ring;
    for (int i = 0; i < walk.steps; ++i, ring.next()) {
      mbar_wait_bounded(empty + ring.slot, ring.phase ^ 1);
      char* slot = base + 2 * L::kKv + ring.slot * L::kSlot;
      uint64_t* bar = full + ring.slot;
      mbar_expect_tx(bar, 3 * L::kQ + kStatBytes);
      const int bh = walk.bh(i), q0 = walk.q0(i), row = bh * s + q0;
      load_rows<D>(slot, kBlk, &qmap, row, bar);
      load_rows<D>(slot + L::kQ, kBlk, &dmap, row, bar);
      load_rows<D>(slot + 2 * L::kQ, kBlk, &dmap, rows_q + row, bar);
      bulk_g2s(slot + 3 * L::kQ, stats + stat_at(bh, s, q0, 0), kStatBytes, bar);
    }
    return;
  }
  const Lane ln;
  float acc[D / 2];
  zero(acc);
  mbar_wait_bounded(kv, 0);
  if (ln.wg == kDv)
    dkdv_consume<kDv, D>(acc, base, full, empty, walk, k0, causal, window, kv_len,
                         scale * kLog2e);
  else
    dkdv_consume<kDk, D>(acc, base, full, empty, walk, k0, causal, window, kv_len,
                         scale * kLog2e);
  const float f = ln.wg == kDv ? 1.0f : scale;
  __nv_bfloat16* out = ln.wg == kDv ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (static_cast<size_t>(kvi) * s + k0 + ln.row + 8 * r) * D + 2 * ln.t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * f, acc[4 * j + 2 * r + 1] * f);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int bh, int h, int kvh, int s,
           int kv_len, int causal, int window, float scale, cudaStream_t st) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(dout) ||
      !aligned16(stats))
    return cudaErrorInvalidValue;
  float* sf = static_cast<float*>(stats);
  auto* dterms = reinterpret_cast<__nv_bfloat16*>(sf + 3 * static_cast<size_t>(bh) * s);
  const uint64_t rows_q = static_cast<uint64_t>(bh) * s, rows_kv = rows_q / h * kvh;
  // q, k, v and dO's two planes as rows of D bf16, boxes of 64 x 64
  CUtensorMap qmap{}, kmap{}, vmap{}, dmap{};
  const void* bases[4] = {q, k, v, dterms};
  CUtensorMap* maps[4] = {&qmap, &kmap, &vmap, &dmap};
  const uint64_t rows[4] = {rows_q, rows_kv, rows_kv, 2 * rows_q};
  cudaError_t e;
  for (int i = 0; i < 4; ++i)
    if ((e = encode_tensor_map_2d(maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[i], D,
                                  rows[i], 2ull * D, 64, kBlk, CU_TENSOR_MAP_SWIZZLE_128B)) !=
        cudaSuccess)
      return e;
  auto prep = fa_bwd16_rows<kPrep, D>;
  auto dkdv = fa_bwd16_dkdv<D>;
  auto dqk = fa_bwd16_rows<kDq, D>;
  if ((e = ensure_smem(prep, RowsLayout<kPrep, D>::kSmem)) != cudaSuccess ||
      (e = ensure_smem(dkdv, DkdvLayout<D>::kSmem)) != cudaSuccess ||
      (e = ensure_smem(dqk, RowsLayout<kDq, D>::kSmem)) != cudaSuccess)
    return e;
  const float *of = static_cast<const float*>(o), *dof = static_cast<const float*>(dout);
  const dim3 rows_grid(bh, s / kBq);
  prep<<<rows_grid, kThreads16, RowsLayout<kPrep, D>::kSmem, st>>>(
      qmap, kmap, vmap, dmap, of, dof, sf, dterms, nullptr, h, kvh, s, kv_len, causal, window,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv<<<dim3(bh / h * kvh, s / kBlk), kThreads16, DkdvLayout<D>::kSmem, st>>>(
      qmap, kmap, vmap, dmap, sf, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), h, kvh, s, kv_len, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dqk<<<rows_grid, kThreads16, RowsLayout<kDq, D>::kSmem, st>>>(
      qmap, kmap, vmap, dmap, of, dof, sf, dterms, static_cast<__nv_bfloat16*>(dq), h, kvh, s,
      kv_len, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace fa_bwd16

// ------------------------------------------------------------------ f32 --

namespace fa_bwd {

using namespace rt;

constexpr float kLog2e = 1.44269504088896340736f;
constexpr int kStats = 3 * kBlk;   // m, 1 / l and Delta of a block's 64 rows

// A 64 x D f32 tile in shared memory, its rows padded by 4 floats (a pitch
// of 4 banks mod 32): ldmatrix's 8 rows of 16 bytes, and product_cols'
// float4 loads of rows 2 t, 2 t + 1 at columns 4 g, fall in distinct banks
template <int D>
struct Tile {
  static constexpr int kPitch = D + 4;   // floats
  static constexpr int kFloats = kBlk * kPitch;
};

// This thread's place: warp w owns rows 16 mw .. 16 mw + 15 of the block's
// 64 (mw = w % 4) and half nw = w / 4 of the other operand's 64 rows (32
// columns of a 64 x 64 logit block); lane (g, t) = (lane / 4, lane % 4)
struct Lane {
  int lane, g, t, mw, nw;
  __device__ __forceinline__ Lane()
      : lane(threadIdx.x % 32), g(threadIdx.x % 32 / 4), t(threadIdx.x % 4),
        mw(threadIdx.x / 32 % 4), nw(threadIdx.x / 128) {}
};

// rows [0, 64) of a (rows, D) f32 matrix at src -> a padded tile at dst,
// 16 bytes a cp.async
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kBlk * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    cp_async16(dst + r * Tile<D>::kPitch + c, src + static_cast<size_t>(r) * D + c);
  }
}
// m, 1 / l and Delta of stats rows row .. row + 63 (each a plane of `plane`
// floats) -> dst[0, 64), [64, 128), [128, 192)
__device__ __forceinline__ void load_stats(float* dst, const float* stats, size_t plane,
                                           size_t row) {
  if (threadIdx.x < kStats / 4) {
    const int which = threadIdx.x / (kBlk / 4), c = 4 * (threadIdx.x % (kBlk / 4));
    cp_async16(dst + which * kBlk + c, stats + which * plane + row + c);
  }
}

// c (16 x 8 NB; n-block n its columns 8 n ..) = a (16 rows) b (8 NB
// rows)^T over D, in 3xTF32: k-step ks takes columns 8 ks .. 8 ks + 7 in
// order.  Both operands by ldmatrix.x4, which moves 8 x 8 b16 matrices,
// i.e. 8 x 4 f32 ones with lane (g, t) getting f32 (g, t): A's four are
// rows 0-7 and 8-15 at columns 0-3, then at 4-7 (a0..a3); B's rows 0-7 at
// columns 0-3 and 4-7 (b0, b1 of an n-block), then rows 8-15.  Each value
// is split into hi and lo as it is loaded.
template <int D, int NB>
__device__ __forceinline__ void product_rows(float (&c)[NB][4], const float* a,
                                             const float* b, int lane) {
  constexpr int P = Tile<D>::kPitch;
  const int r8 = lane % 8, mi = lane / 8;
  const uint32_t pa = smem_u32(a + (r8 + 8 * (mi % 2)) * P + 4 * (mi / 2));
  const uint32_t pb = smem_u32(b + (r8 + 8 * (mi / 2)) * P + 4 * (mi % 2));
#pragma unroll
  for (int n = 0; n < NB; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
#pragma unroll 4
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t x[4], ah[4], al[4];
    ldmatrix_x4(x, pa + 32 * ks);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_rz(__uint_as_float(x[i]), ah[i], al[i]);
#pragma unroll
    for (int p = 0; p < NB / 2; ++p) {
      uint32_t y[4];
      ldmatrix_x4(y, pb + 64 * P * p + 32 * ks);   // n-blocks 2 p, 2 p + 1: 16 rows on
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bh[2], bl[2];
        split_rz(__uint_as_float(y[2 * n]), bh[0], bl[0]);
        split_rz(__uint_as_float(y[2 * n + 1]), bh[1], bl[1]);
        mma3(c[2 * p + n], ah, al, bh, bl);
      }
    }
  }
}

// acc (16 x D) += a (16 x 8 J) y (8 J rows x D), in 3xTF32.  a is made
// of product_rows results read in place as A fragments: n-block j is
// k-step j, k slot t its column 2 t and slot t + 4 its column 2 t + 1
// (a0..a3 = c0, c2, c1, c3), so that step's B rows are y's rows 8 j + 2 t
// and 8 j + 2 t + 1.  N-block 4 c + i of acc is the output columns 32 c +
// 4 g' + i for its B column g', so that one float4 of a y row feeds four
// n-blocks; its C column 2 t + e is output column 32 c + 8 t + 4 e + i.
// Each group of four n-blocks sums the J k-steps from zero and is then
// added to acc in f32: the tensor core's f32 accumulation is not rounded
// to nearest, and a dK/dV sum of some 400 steps (12 mma.sync each) chained
// in one accumulator drifted to 8.8e-5 relative l2 at the h100 cell on an
// NVIDIA H100, past the 2e-5 bound.
template <int D, int J>
__device__ __forceinline__ void product_cols(float (&acc)[D / 8][4], const float (&a)[J][4],
                                             const float* y, int g, int t) {
  constexpr int P = Tile<D>::kPitch;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint32_t ah[4], al[4];
      split_rz(a[j][0], ah[0], al[0]);
      split_rz(a[j][2], ah[1], al[1]);
      split_rz(a[j][1], ah[2], al[2]);
      split_rz(a[j][3], ah[3], al[3]);
      const float* r0 = y + (8 * j + 2 * t) * P + 4 * g + 32 * c;
      const float4 u = *reinterpret_cast<const float4*>(r0);
      const float4 w = *reinterpret_cast<const float4*>(r0 + P);
      const float u4[4] = {u.x, u.y, u.z, u.w}, w4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t bh[2], bl[2];
        split_rz(u4[i], bh[0], bl[0]);
        split_rz(w4[i], bh[1], bl[1]);
        mma3(part[i], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * c + i][e] += part[i][e];
  }
}

// This warp's rows of acc (product_cols' layout: rows 16 mw + g and + 8,
// columns 32 c + 8 t .. + 7) times f into a row-major matrix of `pitch`
// floats a row at dst
template <int D>
__device__ __forceinline__ void put_cols(float* dst, int pitch, const float (&acc)[D / 8][4],
                                         const Lane& ln, float f) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* p = dst + (16 * ln.mw + ln.g + 8 * r) * pitch + 8 * ln.t;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(p + 32 * c + 4 * e) =
            make_float4(acc[4 * c][2 * r + e] * f, acc[4 * c + 1][2 * r + e] * f,
                        acc[4 * c + 2][2 * r + e] * f, acc[4 * c + 3][2 * r + e] * f);
  }
}
// acc = the other half's partial sums (put_cols' layout in a tile) + acc
template <int D>
__device__ __forceinline__ void add_cols(float (&acc)[D / 8][4], const float* src,
                                         const Lane& ln) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* p = src + (16 * ln.mw + ln.g + 8 * r) * Tile<D>::kPitch + 8 * ln.t;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 x = *reinterpret_cast<const float4*>(p + 32 * c + 4 * e);
        acc[4 * c][2 * r + e] = x.x + acc[4 * c][2 * r + e];
        acc[4 * c + 1][2 * r + e] = x.y + acc[4 * c + 1][2 * r + e];
        acc[4 * c + 2][2 * r + e] = x.z + acc[4 * c + 2][2 * r + e];
        acc[4 * c + 3][2 * r + e] = x.w + acc[4 * c + 3][2 * r + e];
      }
  }
}

// prep: Delta = rowsum(dO o O) and each row's (m, 1 / l), m in units of
// log2, the statistics as (bh, s) planes: stats[0] = m, stats[1] = 1 / l,
// stats[2] = Delta.  Block (x, y): q head x of the (B H) flattened heads,
// query block gridDim.y - 1 - y of kBq = 128 rows (the forward's); q
// resident, K through kPrepDepth slots of 64 keys.  Warp w owns rows 16 w
// .. 16 w + 15, a 16 x 64 logit tile a key block: its rows' running max and
// each lane's share of l over its columns 8 j + 2 t + e, the quad's shares
// summed at the end.
constexpr int kPrepDepth = 3;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_prep(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ stats, int h, int kvh, int s, int kv_len, int causal,
                int window, float scale) {
  using T = Tile<D>;
  float* q_s = reinterpret_cast<float*>(smem);
  float* ring = q_s + 2 * T::kFloats;   // kPrepDepth K slots
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int kv = (bh / h) * kvh + (bh % h) / (h / kvh);
  const size_t plane = static_cast<size_t>(gridDim.x) * s;
  const size_t row0 = static_cast<size_t>(bh) * s + q0;
  int lo, hi;
  kv_tiles(q0, s, causal, window, kv_len, &lo, &hi);
  auto issue = [&](int kb) {
    if (kb < 2 * hi)
      load_tile<D>(ring + (kb - 2 * lo) % kPrepDepth * T::kFloats,
                   k + (static_cast<size_t>(kv) * s + kb * kBlk) * D);
    cp_commit();
  };
  load_tile<D>(q_s, q + row0 * D);
  load_tile<D>(q_s + T::kFloats, q + (row0 + kBlk) * D);
  for (int i = 0; i < kPrepDepth - 1; ++i) issue(2 * lo + i);
  // Delta: a warp a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBq; r += kThreads / 32) {
    const size_t row = row0 + r;
    float acc = 0.0f;
    for (int c = lane; c < D; c += 32) acc = fmaf(o[row * D + c], dout[row * D + c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) stats[2 * plane + row] = acc;
  }
  const int g = lane / 4, t = lane % 4;
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};   // rows 16 warp + g, + 8
  for (int kb = 2 * lo; kb < 2 * hi; ++kb) {
    issue(kb + kPrepDepth - 1);
    cp_wait<kPrepDepth - 1>();
    __syncthreads();
    float sa[8][4];
    product_rows<D, 8>(sa, q_s + 16 * warp * T::kPitch,
                       ring + (kb - 2 * lo) % kPrepDepth * T::kFloats, lane);
    const int k0 = kb * kBlk;
    const bool mask = fa_bwd16::needs_mask(q0 + kBlk * (warp / 4), k0, causal, window, kv_len);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + 16 * warp + g + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sa[j][2 * r + e];
          x *= scale2;
          if (mask && !visible(qi, k0 + 8 * j + 2 * t + e, causal, window, kv_len)) x = kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += exp2f(sa[j][2 * r + e] - mn);
      l[r] = l[r] * exp2f(m[r] - mn) + sum;
      m[r] = mn;
    }
    __syncthreads();   // the slot's reads are done before it is refilled
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (t == 0) {
      const size_t row = row0 + 16 * warp + g + 8 * r;
      stats[row] = m[r];
      stats[plane + row] = sum > 0.0f ? 1.0f / sum : 0.0f;
    }
  }
}

// dK/dV, block (x, y): kv head x of the (B KVH) flattened heads, keys 64 y
// .. (key block 0, which every causal query block visits, dispatched
// first); K and V resident, the walk's 64-row query blocks (fa_bwd16::
// DkdvWalk) through two slots of q, dO and the rows' statistics.  Keys are
// the M rows: warp (mw, nw) makes S^T = K Q^T and dP^T = V dO^T for its 16
// keys and its half nw of the step's 64 queries (product_rows), and P^T
// and dS^T on the accumulators.  Then the nw = 0 warps sum dV += P^T dO
// and the nw = 1 warps dK += dS^T Q over all 64 queries (product_cols,
// the accumulators as A): each hands the other half what it lacks, dS^T
// or P^T, through shared memory in its own register order, so that a
// thread holds one D-wide sum (dK or dV, D / 4 registers) and no halves
// meet at the end.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ stats, float* __restrict__ dk, float* __restrict__ dv,
                int h, int kvh, int s, int kv_len, int causal, int window, float scale) {
  using T = Tile<D>;
  constexpr int kSlot = 2 * T::kFloats + kStats;   // q, dO, the rows' stats
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + T::kFloats;
  float* ring = v_s + T::kFloats;
  // the hand-over: float4 j of thread x's P^T (nw = 1) or dS^T (nw = 0) at
  // float4 j kThreads + x
  float4* x_s = reinterpret_cast<float4*>(ring + 2 * kSlot);
  const int kvi = blockIdx.x, k0 = blockIdx.y * kBlk;
  const size_t plane = static_cast<size_t>(gridDim.x / kvh * h) * s;   // rows of q: B H S
  const size_t krow = static_cast<size_t>(kvi) * s + k0;
  const fa_bwd16::DkdvWalk walk(k0 / kBq, kvi / kvh, kvi % kvh, h, kvh, s, kv_len, causal,
                                window);
  auto issue = [&](int i) {
    float* slot = ring + (i % 2) * kSlot;
    const size_t row = static_cast<size_t>(walk.bh(i)) * s + walk.q0(i);
    load_tile<D>(slot, q + row * D);
    load_tile<D>(slot + T::kFloats, dout + row * D);
    load_stats(slot + 2 * T::kFloats, stats, plane, row);
  };
  load_tile<D>(k_s, k + krow * D);
  load_tile<D>(v_s, v + krow * D);
  if (walk.steps > 0) issue(0);
  cp_commit();
  const Lane ln;
  const float scale2 = scale * kLog2e;
  float acc[D / 8][4];   // dV (nw = 0) or dK (nw = 1) of this warp's 16 keys
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const float* ka = k_s + 16 * ln.mw * T::kPitch;   // this warp's 16 keys
  const float* va = v_s + 16 * ln.mw * T::kPitch;
  const int kj = k0 + 16 * ln.mw + ln.g;            // its key of rows r = 0 (and + 8)
  for (int i = 0; i < walk.steps; ++i) {
    if (i + 1 < walk.steps) issue(i + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* qs = ring + (i % 2) * kSlot;
    const float* dos = qs + T::kFloats;
    const float* st = qs + 2 * T::kFloats + 32 * ln.nw;   // this warp's 32 queries' stats
    const int q0 = walk.q0(i), qj = q0 + 32 * ln.nw;
    float sa[4][4], pa[4][4];
    product_rows<D, 4>(sa, ka, qs + 32 * ln.nw * T::kPitch, ln.lane);    // S^T = K Q^T
    product_rows<D, 4>(pa, va, dos + 32 * ln.nw * T::kPitch, ln.lane);   // dP^T = V dO^T
    // P^T = exp2(x - m) / l and dS^T = P^T o (dP^T - Delta) (0 where
    // masked) by query column 8 j + 2 t + e
    const bool mask = fa_bwd16::needs_mask(q0, k0, causal, window, kv_len);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * ln.t;
      const float2 mq = *reinterpret_cast<const float2*>(st + c);
      const float2 rl = *reinterpret_cast<const float2*>(st + kBlk + c);
      const float2 dl = *reinterpret_cast<const float2*>(st + 2 * kBlk + c);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * r + e;
          const bool keep = !mask || visible(qj + c + e, kj + 8 * r, causal, window, kv_len);
          const float p = exp2f((keep ? sa[j][n] * scale2 : kNegInf) - (e ? mq.y : mq.x)) *
                          (e ? rl.y : rl.x);
          sa[j][n] = p;
          pa[j][n] = keep ? p * (pa[j][n] - (e ? dl.y : dl.x)) : 0.0f;
        }
    }
    // hand over dS^T (nw = 0) or P^T (nw = 1); A of the 64 queries in order
    float a[8][4];
    const float4* other = x_s + (threadIdx.x ^ 128);   // the same lane of warp w ^ 4
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x_s[j * kThreads + threadIdx.x] =
          ln.nw == 0 ? make_float4(pa[j][0], pa[j][1], pa[j][2], pa[j][3])
                     : make_float4(sa[j][0], sa[j][1], sa[j][2], sa[j][3]);
    __syncthreads();
    if (ln.nw == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = other[j * kThreads];
        a[j][0] = sa[j][0], a[j][1] = sa[j][1], a[j][2] = sa[j][2], a[j][3] = sa[j][3];
        a[4 + j][0] = x.x, a[4 + j][1] = x.y, a[4 + j][2] = x.z, a[4 + j][3] = x.w;
      }
      product_cols<D, 8>(acc, a, dos, ln.g, ln.t);   // dV += P^T dO
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = other[j * kThreads];
        a[j][0] = x.x, a[j][1] = x.y, a[j][2] = x.z, a[j][3] = x.w;
        a[4 + j][0] = pa[j][0], a[4 + j][1] = pa[j][1], a[4 + j][2] = pa[j][2],
        a[4 + j][3] = pa[j][3];
      }
      product_cols<D, 8>(acc, a, qs, ln.g, ln.t);    // dK += dS^T Q
    }
    __syncthreads();   // the slot's and the hand-over's reads are done
  }
  cp_wait<0>();
  if (ln.nw == 0)
    put_cols<D>(dv + krow * D, D, acc, ln, 1.0f);
  else
    put_cols<D>(dk + krow * D, D, acc, ln, scale);
}

// dQ, block (x, y): q head x, query block gridDim.y - 1 - y of 64 rows; q,
// dO and the rows' statistics resident, K and V through two slots over the
// forward's key tiles in 64-key blocks.  S = Q K^T and dP = dO V^T
// (product_rows), dS on the accumulators, dQ += dS K (product_cols).  Warp
// (mw, nw) sums its 16 rows over its 32 keys of every block; the nw = 1
// warps hand theirs to the nw = 0 warps at the end.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ stats, float* __restrict__ dq, int h, int kvh, int s,
              int kv_len, int causal, int window, float scale) {
  using T = Tile<D>;
  constexpr int kSlot = 2 * T::kFloats;   // K, V
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + T::kFloats;
  float* st = do_s + T::kFloats;
  float* ring = st + kStats;
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;
  const int kv = (bh / h) * kvh + (bh % h) / (h / kvh);
  const size_t plane = static_cast<size_t>(gridDim.x) * s;
  const size_t row0 = static_cast<size_t>(bh) * s + q0;
  int lo, hi;
  kv_tiles(q0 - q0 % kBq, s, causal, window, kv_len, &lo, &hi);
  auto issue = [&](int kb) {
    float* slot = ring + (kb % 2) * kSlot;
    const size_t krow = static_cast<size_t>(kv) * s + kb * kBlk;
    load_tile<D>(slot, k + krow * D);
    load_tile<D>(slot + T::kFloats, v + krow * D);
  };
  load_tile<D>(q_s, q + row0 * D);
  load_tile<D>(do_s, dout + row0 * D);
  load_stats(st, stats, plane, row0);
  if (lo < hi) issue(2 * lo);
  cp_commit();
  const Lane ln;
  const float scale2 = scale * kLog2e;
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;
  const int row = 16 * ln.mw + ln.g;   // this thread's rows row, row + 8 of the block
  const float* qa = q_s + 16 * ln.mw * T::kPitch;
  const float* da = do_s + 16 * ln.mw * T::kPitch;
  for (int kb = 2 * lo; kb < 2 * hi; ++kb) {
    if (kb + 1 < 2 * hi) issue(kb + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* slot = ring + (kb % 2) * kSlot;
    const float* ks = slot + 32 * ln.nw * T::kPitch;   // this warp's 32 keys
    const float* vs = slot + T::kFloats + 32 * ln.nw * T::kPitch;
    float sa[4][4], pa[4][4];
    product_rows<D, 4>(sa, qa, ks, ln.lane);   // S = Q K^T
    product_rows<D, 4>(pa, da, vs, ln.lane);   // dP = dO V^T
    const int k0 = kb * kBlk + 32 * ln.nw;
    const bool mask = fa_bwd16::needs_mask(q0, kb * kBlk, causal, window, kv_len);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row + 8 * r;
      const float m = st[row + 8 * r], rl = st[kBlk + row + 8 * r],
                  dl = st[2 * kBlk + row + 8 * r];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * r + e;
          const bool keep =
              !mask || visible(qi, k0 + 8 * j + 2 * ln.t + e, causal, window, kv_len);
          const float p = exp2f((keep ? sa[j][n] * scale2 : kNegInf) - m) * rl;
          pa[j][n] = keep ? p * (pa[j][n] - dl) : 0.0f;
        }
    }
    product_cols<D, 4>(dqa, pa, ks, ln.g, ln.t);   // dQ += dS K
    __syncthreads();   // the slot's reads are done before it is refilled
  }
  cp_wait<0>();
  if (ln.nw == 1) put_cols<D>(ring, T::kPitch, dqa, ln, 1.0f);
  __syncthreads();
  if (ln.nw == 0) {
    add_cols<D>(dqa, ring, ln);
    put_cols<D>(dq + row0 * D, D, dqa, ln, scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int bh, int h, int kvh, int s,
           int kv_len, int causal, int window, float scale, cudaStream_t st) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv) || !aligned16(stats))
    return cudaErrorInvalidValue;
  constexpr int tile = Tile<D>::kFloats * 4;
  constexpr int prep_smem = (2 + kPrepDepth) * tile;
  // K, V; two slots of q, dO and stats; the hand-over's 16 floats a thread
  constexpr int dkdv_smem = 2 * tile + 2 * (2 * tile + kStats * 4) + kThreads * 64;
  constexpr int dq_smem = 2 * tile + kStats * 4 + 2 * 2 * tile;
  auto prep = fa_bwd_prep<D>;
  auto dkdv = fa_bwd_dkdv<D>;
  auto dqk = fa_bwd_dq<D>;
  cudaError_t e;
  if ((e = ensure_smem(prep, prep_smem)) != cudaSuccess ||
      (e = ensure_smem(dkdv, dkdv_smem)) != cudaSuccess ||
      (e = ensure_smem(dqk, dq_smem)) != cudaSuccess)
    return e;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
              *dof = static_cast<const float*>(dout);
  float* sf = static_cast<float*>(stats);
  prep<<<dim3(bh, s / kBq), kThreads, prep_smem, st>>>(qf, kf, of, dof, sf, h, kvh, s, kv_len,
                                                      causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv<<<dim3(bh / h * kvh, s / kBlk), kThreads, dkdv_smem, st>>>(
      qf, kf, vf, dof, sf, static_cast<float*>(dk), static_cast<float*>(dv), h, kvh, s, kv_len,
      causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dqk<<<dim3(bh, s / kBlk), kThreads, dq_smem, st>>>(
      qf, kf, vf, dof, sf, static_cast<float*>(dq), h, kvh, s, kv_len, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace fa_bwd

// dq (bh, s, d), dk and dv (bh / h * kvh, s, d) of the attention of q (bh, s,
// d) over k, v (bh / h * kvh, s, d), all f32 (bf16 = 0) or all bf16 (bf16 =
// 1), given the forward's output o and its gradient dout (both (bh, s, d)
// f32); stats is f32 scratch of 3 x bh x s, and in bf16 bh x s x d more
// (dO's two bf16 terms), each pointer on 16 bytes.  bh = B * h flattened q
// heads, h % kvh == 0, s % 128 == 0, d in {64, 128}; causal, window (> 0: a
// sliding window) and the key count kv_len (1 <= kv_len <= s) mask as the
// forward.  Three launches on `stream`, no synchronisation; returns a
// cudaError_t.
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
    return bf16 ? fa_bwd16::launch<64>(q, k, v, o, dout, dq, dk, dv, stats, bh, h, kvh, s,
                                       kv_len, causal, window, scale, st)
                : fa_bwd::launch<64>(q, k, v, o, dout, dq, dk, dv, stats, bh, h, kvh, s,
                                     kv_len, causal, window, scale, st);
  if (d == 128)
    return bf16 ? fa_bwd16::launch<128>(q, k, v, o, dout, dq, dk, dv, stats, bh, h, kvh, s,
                                        kv_len, causal, window, scale, st)
                : fa_bwd::launch<128>(q, k, v, o, dout, dq, dk, dv, stats, bh, h, kvh, s,
                                      kv_len, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
