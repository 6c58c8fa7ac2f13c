// Tiled matmul for Hopper: C (M, N) f32 = A (M, K) @ B (K, N), A and B both
// f32 or both bf16, the K loop streamed through the strategy's ring.
//
// Replaces src/repro/kernels/matmul.py: matmul_pallas (line 63) and its body
// _matmul_kernel (line 26).  As there, one block owns one output tile,
// streams the A (128 x kc) and B (kc x tile width) tiles of its K loop,
// keeps the accumulator on chip and drains it to C once after the loop.
// The reference's blocks are 128 x 128; the card's are its own business:
// bf16 128 x 128, f32 128 x 256.  The reference's bk is its K granularity;
// on the card each bk is kc-row sub-tiles, so that a ring of depth 4 fits a
// block's shared memory (f32 at bk = 128 would be 192 KB a slot).
//
// Bound: operations.  At the h100/matmul shape (8192, 1536, 8960) bf16 the
// product is 225.5 GFLOP against 346 MB of A, B and C: 0.228 ms at the
// 989 TFLOP/s bf16 tensor-core rate, 0.103 ms at the HBM rate; in f32 it is
// 3.37 ms at the 66.9 TFLOP/s FFMA rate.  What the design does about it:
// the re-reads of A (once per N tile) and B (once per M tile) are L2 hits
// while the ring keeps `ahead` sub-tiles in flight, and the blocks run in
// groups of kGroupRows row tiles (all column tiles of a group before the
// next), so that what a wave reads stays in the L2; f32 runs FFMA from
// float4 loads (no TF32, which would break the reference's 1e-4); bf16 runs
// wgmma, the only way to the full tensor-core rate, with two blocks an SM
// (at most 128 registers a thread) so that one block's barriers and copies
// overlap the other's MMAs.  bf16 at 128 x 128 tiles reads 3.5 GB of A and
// B from the L2 at the h100 shape; a wave of 264 blocks reads 16 row tiles
// of A and about 17 column tiles of B (13 MB).
//
// f32 (MatmulF32Body<S, BN>).  One block an SM (__launch_bounds__(256, 1):
// up to 255 registers a thread).  Thread t owns rows ty + 16 i (i < 8, ty =
// t / 16) and columns 4 tx + 64 j .. 4 tx + 64 j + 3 (j < BN / 64, tx = t %
// 16): at BN = kF32Wide = 256, 8 x 16 = 128 sums.  Per 4 k it loads 8
// float4 of A and 16 of B for 512 FFMAs (21 a 16-byte load; 128 x 128 tiles
// gave 16).  The slot's K loop is unrolled whole, so ptxas hoists the next
// fragments' loads over the FFMAs (a fragment double buffer written out in
// the source left the loop half unrolled, with lane selects).  At
// the h100 shape the blocks read A 35 times and B 64 times from the L2,
// 5.28 GB (128 x 128 tiles: 7.05 GB); a wave of 132 blocks reads 16 row
// tiles of A and about 8 column tiles of B (26 MB).  When n % 256 == 128
// the last 128 columns run as a second launch of the BN = 128 instantiation
// (8 x 8 sums a thread).  A slot (MmF32Shape) is A's tile, 128 rows of kc =
// 32 floats, then B's, kc rows of BN floats.  The copies pad every row
// pitch by 16 bytes, so the two A rows a warp reads fall in distinct banks
// (B's 256 contiguous bytes a warp do anyway): 51,712 bytes a slot at BN =
// 256.  TMA loads each slot as two boxes from 2-D tensor maps: A's 128 x 32
// box, whose 128-byte rows land in the 128-byte swizzle (chunk q of row r
// at r * 128 + ((q ^ (r & 7)) << 4), the ring base on 1024 bytes; a box
// cannot be padded), and B's dense 32 x BN box: 49,152 bytes a slot.
// DROP_OFF holds a thread's share of a slot in registers beside the sums:
// at 8 x 16 even a 4-row slot (96 registers) would spill, so DROP_OFF runs
// the BN = 128 instantiation on every column, kc = 4, two blocks an SM.
// No out ring: the launcher declares kTileOutput = false.
//
// bf16 (MatmulBf16Body).  kc = 64 at every strategy, so a slot row is 128
// bytes: A is 128 rows x 128 B, K-major; B is two halves of 64 K rows x
// 128 B, one per 64 output columns, N-major (B is row-major (K, N)).  Each
// of the three is stored in the 128-byte swizzle (chunk q of row r at
// r * 128 + ((q ^ (r & 7)) << 4)): a 32 KB slot whose parts start on 1024
// bytes, after the ring base is rounded up to 1024 (the launcher budgets
// 1024 bytes for it).  The two warpgroups of the 256 threads own 64 output
// rows each and run wgmma.mma_async m64n128k16 with 64 f32 accumulators a
// thread; the shared-memory descriptors are built here from the PTX ISA's
// canonical layouts (start >> 4, SWIZZLE_128B; A: SBO 1024, the k16 step
// at +32 bytes; B: LBO 8192 between the halves, SBO 1024 between 8-row
// groups, the k16 step at +2048 bytes, imm-trans-b = 1).  Per slot, after
// B1 (B0 for DROP_OFF): wgmma.fence, four k16 wgmmas, commit, wait_group 0
// before B2, so run_pipeline may refill the slot.  The body declares
// kAsyncProxyReads: wgmma reads through the async proxy what st.shared or
// cp.async wrote, so every thread fences (fence.proxy.async) before B1.
//
// Batched bf16 (matmul_bf16_batched_kernel, matmul_batched_launch): E
// products of three stacks, (E, Mp, K) x (E, K, N) -> (E, Mp, N), in one
// persistent launch: the model's three expert products of a moe layer (E
// = 60 at qwen2-moe-a2.7b) and xlstm's headwise q, k, v.  Bound: bytes.
// At qwen2-moe's gate product over a 4 x 512 prefill, (60, 256, 2048) x
// (60, 2048, 1408), A, B and C (f32) are 0.495 GB, 0.1479 ms at the HBM
// rate, against 0.0896 ms of bf16 tensor work; B, every expert's weights,
// is 70% of the bytes.  What the design does about it (the full note is at
// the kernel below): a tile is BM = 256 rows when Mp % 256 == 0 (an
// expert's whole prefill rows, so each B sub-tile crosses from the L2 to
// an SM once) or 128 (under TMA by 256 columns); blocks walk the tiles
// persistently, the row tiles of one strip back to back; under TMA a
// producer warp keeps the ring full while two consumer warpgroups run
// wgmma, with no block-wide barrier in the K loop, so the next tile's
// loads overlap a tile's epilogue.  A row's sums are the 2-D kernel's:
// m64n128k16 k16 steps in ascending K from zero, whatever Mp, E, the tile
// or the row's place in it.
//
// Barriers per sub-tile (see async_pipeline.cuh for the loop; O = 0):
//   SYNC            ld.global/st.shared staging (swizzled for bf16), B1,
//                   FMAs/wgmmas, B2
//   REGISTER_BYPASS cp.async, wait_group 0, B1, FMAs/wgmmas, B2
//   OVERLAP         issue i+A, wait_group A, B1, FMAs/wgmmas, B2
//   DROP_OFF        wait_group A-1, B0, operands into registers (bf16: the
//                   slot's A fragments by ldmatrix, 16 registers), issue
//                   i+A, FMAs or register-A wgmmas with B from the held
//                   slot (never the slot of i+A, as A <= depth-1), B2
//   TMA             thread 0 sets expect-tx and issues i+A as
//                   cp.async.bulk.tensor.2d boxes from maps encoded in
//                   matmul_launch: f32 two (A's 32 x 128 box in
//                   CU_TENSOR_MAP_SWIZZLE_128B, B's BN x 32 box dense),
//                   bf16 three in CU_TENSOR_MAP_SWIZZLE_128B (A's 64 x 128
//                   box, B's 64 x 64 box twice); all wait slot parity
//                   (i/depth)&1, B1, FMAs/wgmmas, B2
#include <cuda_bf16.h>

#include "async_pipeline.cuh"
#include "wgmma.cuh"

namespace rt {

constexpr int MM_BM = 128;         // output tile rows (the reference's bm)
constexpr int MM_BN = 128;         // output tile columns (the reference's bn; f32: the strip)
constexpr int kF32Wide = 256;      // f32 output tile columns
constexpr int kRowPad = 16;        // f32: bytes added to every row pitch the copies write
constexpr int kGroupRows = 16;     // row tiles a block group

// Blocks in groups of kGroupRows row tiles, all column tiles of a group
// before the next, so that the A rows and B columns a wave of blocks reads
// stay in the L2: this block's (row tile, column tile).
__device__ __forceinline__ int2 grouped_tile() {
  const int id = blockIdx.x + blockIdx.y * gridDim.x;
  const int first = id / (kGroupRows * gridDim.y) * kGroupRows;
  const int span = min(static_cast<int>(gridDim.x) - first, kGroupRows);
  const int in_group = id % (kGroupRows * gridDim.y);
  return make_int2(first + in_group % span, in_group / span);
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ------------------------------------------------------------------ f32 --

// The f32 ring slot of strategy S at output tile width BN: [A: MM_BM rows
// of kc floats][B: kc rows of BN floats].  The copies pad every row by
// kRowPad bytes; TMA's boxes land dense, A's 128-byte rows in the 128-byte
// swizzle.
template <int S, int BN>
struct MmF32Shape {
  static constexpr int kc = S == DROP_OFF ? 4 : 32;
  static constexpr bool swizzled = S == TMA;
  static constexpr int a_pitch = swizzled ? kc * 4 : kc * 4 + kRowPad;   // bytes
  static constexpr int b_pitch = swizzled ? BN * 4 : BN * 4 + kRowPad;   // bytes
  static constexpr int a_tile = MM_BM * a_pitch;
  static constexpr int slot = a_tile + kc * b_pitch;
  static constexpr int align = swizzled ? 1024 : 1;
  static_assert(!swizzled || kc * 4 == 128, "the swizzle takes rows of 128 bytes");
};

// Dynamic shared memory of one f32 block at ring depth `depth`: [ring base
// padding][ring][TMA mbarriers].
template <int S, int BN>
constexpr int mm_f32_smem(int depth) {
  using P = MmF32Shape<S, BN>;
  return (P::align > 1 ? P::align : 0) + (S == SYNC ? 1 : depth) * P::slot +
         (S == TMA ? 8 * depth : 0);
}

template <int S, int BN>
struct MatmulF32Body {
  using P = MmF32Shape<S, BN>;
  static constexpr int KC = P::kc;
  static constexpr int NJ = BN / 64;      // float4 columns of a thread's row
  static constexpr bool kCrossThreadReads = true;
  static constexpr int kRingAlign = P::align;
  int ty, tx, sw;
  float acc[8][4 * NJ];
  float4 ra[8], rb[KC][NJ];       // DROP_OFF: this thread's A rows and B columns

  __device__ __forceinline__ void init() {
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
    sw = ty & 7;              // (ty + 16 i) & 7: the swizzle of every A row it reads
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.0f;
  }
  // acc += a[:, kk] (x) b
  __device__ __forceinline__ void rank1(const float4 (&a)[8], int kk, const float4 (&b)[NJ]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = lane_of(a[i], kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][4 * j] += x * b[j].x;
        acc[i][4 * j + 1] += x * b[j].y;
        acc[i][4 * j + 2] += x * b[j].z;
        acc[i][4 * j + 3] += x * b[j].w;
      }
    }
  }
  // A's columns k .. k + 3 (k % 4 == 0) of rows ty + 16 i
  __device__ __forceinline__ void load_a(const char* in, int k, float4 (&a)[8]) const {
    const int q = P::swizzled ? (k >> 2) ^ sw : k >> 2;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(in + (ty + 16 * i) * P::a_pitch + (q << 4));
  }
  // B's row k, columns 4 tx + 64 j .. 4 tx + 64 j + 3
  __device__ __forceinline__ void load_b(const char* in, int k, float4 (&b)[NJ]) const {
    const float* row = reinterpret_cast<const float*>(in + P::a_tile + k * P::b_pitch);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = *reinterpret_cast<const float4*>(row + 64 * j + 4 * tx);
  }
  // The slot's K loop unrolled whole: ptxas then hoists the next
  // fragments' loads over this k's FFMAs as registers allow.
  __device__ __forceinline__ void compute(const char* in, char*) {
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 a[8];
      load_a(in, k, a);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[NJ];
        load_b(in, k + kk, b);
        rank1(a, kk, b);
      }
    }
  }
  __device__ __forceinline__ void load(const char* in) {
    static_assert(KC == 4, "DROP_OFF holds one float4 of A per row");
    load_a(in, 0, ra);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) load_b(in, kk, rb[kk]);
  }
  __device__ __forceinline__ void store(char*) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) rank1(ra, kk, rb[kk]);
  }
  __device__ __forceinline__ void drain(float* c, long long ldc) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = c + (ty + 16 * i) * ldc + 4 * tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<float4*>(row + 64 * j) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
};

// ----------------------------------------------------------------- bf16 --

constexpr int kBf16K = 64;                            // K rows of a slot
constexpr int kBf16ATile = MM_BM * 128;               // A: 128 rows x 128 B
constexpr int kBf16BHalf = kBf16K * 128;              // B half: 64 rows x 128 B
constexpr int kBf16Slot = kBf16ATile + 2 * kBf16BHalf;  // 32 KB
constexpr int kBf16Align = 1024;                      // SWIZZLE_128B atoms

struct MatmulBf16Body {
  static constexpr bool kCrossThreadReads = true;
  static constexpr bool kAsyncProxyReads = true;
  static constexpr int kRingAlign = kBf16Align;
  int wg, warp, lane;        // warpgroup, warp in it, lane
  float acc[64];
  uint32_t fa[kBf16K / 16][4];   // DROP_OFF: this warp's A fragments of the slot
  const char* held;              // DROP_OFF: the slot whose B the wgmmas read

  __device__ __forceinline__ void init() {
    wg = threadIdx.x / 128;
    warp = threadIdx.x / 32 % 4;
    lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  }
  // B's descriptor for k16 step s of the slot at `in`.
  __device__ __forceinline__ uint64_t b_desc(const char* in, int s) const {
    return sw128_desc(smem_u32(in) + kBf16ATile + s * 16 * 128, kBf16BHalf, 1024);
  }
  __device__ __forceinline__ void compute(const char* in, char*) {
    const uint32_t a = smem_u32(in) + wg * 64 * 128;
    hold_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBf16K / 16; ++s)
      wgmma_ss<128>(acc, sw128_desc(a + 32 * s, 16, 1024), b_desc(in, s));
    wgmma_commit();
    wgmma_wait_all();
    hold_registers(acc);
  }
  // ldmatrix.x4 at the swizzled rows: lanes 0-15 give rows 0-15 of the
  // warp's 16 at chunk 2 s, lanes 16-31 the same rows at chunk 2 s + 1.
  __device__ __forceinline__ void load(const char* in) {
    held = in;
    const int r = 64 * wg + 16 * warp + (lane & 15);
#pragma unroll
    for (int s = 0; s < kBf16K / 16; ++s) {
      const int q = 2 * s + (lane >> 4);
      ldmatrix_x4(fa[s], smem_u32(in) + r * 128 + ((q ^ (r & 7)) << 4));
    }
  }
  __device__ __forceinline__ void store(char*) {
    hold_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBf16K / 16; ++s) wgmma_rs<128>(acc, fa[s], b_desc(held, s));
    wgmma_commit();
    wgmma_wait_all();
    hold_registers(acc);
  }
  // Accumulators 4 j .. 4 j + 3: rows g and g + 8 of the warp's 16, columns
  // 8 j + 2 q and + 1 (g = lane / 4, q = lane % 4), the wgmma f32 layout.
  __device__ __forceinline__ void drain(float* c, long long ldc) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = c + (64 * wg + 16 * warp + g + 8 * h) * ldc + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
};

// One block an SM: up to 255 registers a thread for the 128 sums and the
// fragments in flight.  DROP_OFF two (at most 128 registers: its slot share
// spills a little, and the second block hides the barriers of its 4-row
// slots).
template <int S, int A, int O, int BN>
__global__ void __launch_bounds__(kThreads, S == DROP_OFF ? 2 : 1)
matmul_f32_kernel(const float* a, const float* b, float* c, int k, int n, int col_base,
                  int depth, const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap) {
  using P = MmF32Shape<S, BN>;
  constexpr int kc = P::kc;
  const int2 tile = grouped_tile();
  const int row0 = tile.x * MM_BM, col0 = col_base + tile.y * BN;
  Operand op[2] = {
      {reinterpret_cast<const char*>(a + static_cast<long long>(row0) * k), 4LL * k, kc * 4,
       MM_BM, kc * 4, P::a_pitch},
      {reinterpret_cast<const char*>(b + col0), 4LL * n, 4LL * kc * n, kc, BN * 4, P::b_pitch}};
  if constexpr (S == TMA) {   // boxes: A at (kc i, row0), swizzled; B at (col0, kc i)
    op[0].map = &amap;
    op[0].y0 = row0;
    op[0].dx = kc;
    op[0].swizzle128 = true;
    op[1].map = &bmap;
    op[1].x0 = col0;
    op[1].dy = kc;
  }
  MatmulF32Body<S, BN> body;
  body.init();
  run_pipeline<S, A, O>(body, op, op[0], k / kc, depth);
  body.drain(c + static_cast<long long>(row0) * n + col0, n);
}

// Two blocks an SM: at most 128 registers a thread.
template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads, 2)
matmul_bf16_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b, float* c, int k, int n,
                   int depth, const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap) {
  const int2 tile = grouped_tile();
  const int row0 = tile.x * MM_BM, col0 = tile.y * MM_BN;
  const char* ga = reinterpret_cast<const char*>(a + static_cast<long long>(row0) * k);
  const char* gb = reinterpret_cast<const char*>(b + col0);
  const long long bstep = 2LL * kBf16K * n;
  Operand op[3] = {{ga, 2LL * k, 2 * kBf16K, MM_BM, 128, 128},
                   {gb, 2LL * n, bstep, kBf16K, 128, 128},
                   {gb + 128, 2LL * n, bstep, kBf16K, 128, 128}};
#pragma unroll
  for (int i = 0; i < 3; ++i) op[i].swizzle128 = true;
  if constexpr (S == TMA) {   // boxes: A at (64 i, row0), B at (col0 [+ 64], 64 i)
    op[0].map = &amap;
    op[0].y0 = row0;
    op[0].dx = kBf16K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      op[1 + h].map = &bmap;
      op[1 + h].x0 = col0 + 64 * h;
      op[1 + h].dy = kBf16K;
    }
  }
  MatmulBf16Body body;
  body.init();
  run_pipeline<S, A, O>(body, op, op[0], k / kBf16K, depth);
  body.drain(c + static_cast<long long>(row0) * n + col0, n);
}

// ------------------------------------------------------ batched bf16 --
// The batched launch (matmul_batched_launch): E independent products C[e]
// (Mp, N) = A[e] (Mp, K) @ B[e] (K, N) of three contiguous stacks.
//
// Tiles.  A tile is BM rows of one expert by a 128-column strip, BM = 256
// where Mp % 256 == 0 (qwen2-moe's prefill, Mp = 256; xlstm's headwise
// products, Mp = B S), else 128 (a decode step, Mp = 128).  At BM = 256 a
// tile holds an expert's whole 256 rows, so each B sub-tile crosses from
// the L2 to an SM once: at the prefill shape the SMs read 660 tiles x 32
// slots x 48 KB = 1.04 GB from the L2 (1.38 GB in 128-row tiles).  Under
// TMA a 128-row tile is 256 columns wide (BN; 128 otherwise), so that its
// slot holds as many bytes as at 256 rows: what bounds this kernel on the
// card is the bytes its ring keeps in flight, not the L2's reads, and a
// decode step reads little but weights.  A slot is A's BM rows of 128
// bytes (BM x 64 bf16, K-major), then B's BN / 64 halves of 64 K rows x
// 128 bytes, all in the 128-byte swizzle, each part on 1024 bytes: 48 KB,
// but 32 KB at 128 x 128.  A warpgroup owns BM / 2 rows of a 128-column
// tile, or one 128-column strip of a 256-column one: MI = BM BN / 16384
// blocks of 64 x 128 (BatchedBody), 128 f32 accumulators a thread at MI =
// 2, and per slot MI x 4 m64n128k16 wgmmas (B's descriptors as
// MatmulBf16Body's, at its strip; A's at its block's 64 rows).
//
// The walk.  The grid is min(tiles, SMs x blocks an SM), and block x runs
// tiles t = x, x + grid, ... in the order (expert, strip, row tile), so the
// row tiles of one strip run at once on neighbouring blocks (B from the
// HBM once, then from the L2).  The prefill's 660 tiles are 5 a block, a
// decode step's 360 (6 of 256 columns an expert, the last one strip) 2-3.
//
// TMA (384 threads, one block an SM): warpgroup 0 is the producer, 1 and
// 2 the consumers, and no block-wide barrier follows the set-up.  The
// producer gives registers back (40 a thread) and the consumers take them
// (232).  The producer's thread 0 walks the tiles' slots into a ring of
// `depth` slots: it waits on the slot's empty mbarrier, sets expect-tx on
// its full mbarrier and issues A's BM x 64 box and B's BN / 64 boxes of 64
// x 64 (maps over the flattened stacks (E Mp, K) and (E K, N): A at row e
// Mp + row0, B at row e K + 64 i; Mp and K are multiples of the boxes'
// rows, so no box straddles two experts).  Each consumer waits on the full
// mbarrier, issues the slot's wgmmas as one group, waits for it
// (wgmma.wait_group 0) and frees the slot at once: one arrival a consumer
// warpgroup on its empty mbarrier (count 2).  So while the consumers
// compute slot i the producer has slots i + 1 .. i + depth - 1 in flight,
// run_pipeline's lead (PipelineSpec.ahead = depth - 1: the kernel has no A
// of its own, one instantiation a BM).  Keeping a group in flight
// (wait_group 1, the slot before freed) held a slot through the next
// slot's whole load, one load in flight at depth 2.  At a tile's end the
// consumers drain C from registers while the producer loads the next
// tile.  The phases count across the walk.  A wait longer than two seconds
// traps (mbar_wait_bounded).
//
// The other strategies run run_pipeline, a call a tile (256 threads, A in
// two 128-row operands so that SYNC's staging holds at most 4 chunks an
// operand a thread), with BatchedBody as MatmulBf16Body on 128-column
// tiles; DROP_OFF holds MI x 16 registers of A fragments.  Two blocks an SM
// at BM = 128, one at 256.

template <int BM, int BN>
struct BatchedShape {
  static_assert((BM == 128 || BM == 256) && (BN == 128 || BN == 256) && BM * BN <= 32768,
                "the batched tile is 128 or 256 rows by 128, or 128 by 256");
  static constexpr int MI = BM * BN / 16384;             // 64 x 128 blocks a warpgroup
  static constexpr int a_tile = BM * 128;                // A: BM rows x 128 B
  static constexpr int b_tile = BN / 64 * kBf16BHalf;    // B: BN / 64 halves
  static constexpr int slot = a_tile + b_tile;           // 32 or 48 KB
};
// TMA's tile at BM rows: 128 x 256 at BM = 128 (one strip a consumer
// warpgroup), else 256 x 128.
template <int S, int BM>
constexpr int kBatchedCols = S == TMA && BM == 128 ? 256 : 128;

constexpr int kBatchedTmaThreads = 384;   // a producer and two consumer warpgroups

// Under TMA the registers a thread of the producer and of the consumer
// warpgroups (setmaxnreg): one block an SM starts every thread at 65536 /
// 384 rounded down to 8, 168, and the two counts spend exactly that (an
// inc past the block's pool would wait for good).  Two blocks an SM would
// start at 80, too few for ptxas to place a wgmma of 64 accumulators.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs == kBatchedTmaThreads * 168,
              "setmaxnreg must spend the block's registers exactly");

template <int BM, int BN>
struct BatchedBody {
  using P = BatchedShape<BM, BN>;
  static constexpr int MI = P::MI;
  static constexpr bool kCrossThreadReads = true;
  static constexpr bool kAsyncProxyReads = true;
  static constexpr int kRingAlign = kBf16Align;
  int wg, warp, lane;            // warpgroup (of the consumers), warp in it, lane
  float acc[MI][64];
  uint32_t fa[MI][kBf16K / 16][4];   // DROP_OFF: this warp's A fragments of the slot
  const char* held;                  // DROP_OFF: the slot whose B the wgmmas read

  __device__ __forceinline__ void init(int group) {
    wg = group;
    warp = threadIdx.x / 32 % 4;
    lane = threadIdx.x % 32;
    zero();
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0.0f;
  }
  __device__ __forceinline__ void hold() {
#pragma unroll
    for (int i = 0; i < MI; ++i) hold_registers(acc[i]);
  }
  // the first row of this warpgroup's block i in the tile: BM / 2 rows a
  // warpgroup at BN = 128, every row of its strip at 256
  __device__ __forceinline__ int row0(int i) const {
    return (BN == 128 ? MI * wg + i : i) * 64;
  }
  // this warpgroup's first column in the tile
  __device__ __forceinline__ int col0() const { return BN == 128 ? 0 : 128 * wg; }
  __device__ __forceinline__ uint64_t b_desc(uint32_t slot, int s) const {
    // a strip's B is 64 K rows x 128 columns x 2 bytes past the one before
    return sw128_desc(slot + P::a_tile + col0() * 2 * kBf16K + s * 16 * 128, kBf16BHalf,
                      1024);
  }
  // The slot's k16 steps on every block as one commit group: a block's
  // four steps in ascending K, as MatmulBf16Body's.
  __device__ __forceinline__ void issue(uint32_t slot) {
    hold();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBf16K / 16; ++s)
#pragma unroll
      for (int i = 0; i < MI; ++i)
        wgmma_ss<128>(acc[i], sw128_desc(slot + row0(i) * 128 + 32 * s, 16, 1024),
                      b_desc(slot, s));
    wgmma_commit();
  }
  __device__ __forceinline__ void compute(const char* in, char*) {
    issue(smem_u32(in));
    wgmma_wait_all();
    hold();
  }
  __device__ __forceinline__ void load(const char* in) {
    held = in;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = row0(i) + 16 * warp + (lane & 15);
#pragma unroll
      for (int s = 0; s < kBf16K / 16; ++s) {
        const int q = 2 * s + (lane >> 4);
        ldmatrix_x4(fa[i][s], smem_u32(in) + r * 128 + ((q ^ (r & 7)) << 4));
      }
    }
  }
  __device__ __forceinline__ void store(char*) {
    hold();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBf16K / 16; ++s)
#pragma unroll
      for (int i = 0; i < MI; ++i) wgmma_rs<128>(acc[i], fa[i][s], b_desc(smem_u32(held), s));
    wgmma_commit();
    wgmma_wait_all();
    hold();
  }
  __device__ __forceinline__ void drain(float* c, long long ldc) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* p = c + (row0(i) + 16 * warp + g + 8 * h) * ldc + col0() + 8 * j + 2 * q;
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
        }
  }
};

// Tile t of the walk: its expert, first row and first column.
struct BatchedTile {
  int e, row0, col0;
};
__device__ __forceinline__ BatchedTile batched_tile(int t, int rows, int strips, int bm,
                                                    int bn) {
  const int x = t / rows;
  return {x / strips, (t - x * rows) * bm, x % strips * bn};
}

// TMA: the producer warp and the two consumer warpgroups (see above), on
// tiles of BM x BN.  At BN = 256 the last tile of an odd strip count has
// one strip: the producer loads that strip's B alone (expect-tx counts
// what it loads) and warpgroup 2 computes on what the slot held and stores
// nothing.
template <int BM>
__device__ __forceinline__ void batched_tma(const CUtensorMap* amap, const CUtensorMap* bmap,
                                            float* c, int n_e, int m, int k, int n, int depth) {
  constexpr int BN = kBatchedCols<TMA, BM>;
  using P = BatchedShape<BM, BN>;
  char* ring = smem + (kBf16Align - smem_u32(smem) % kBf16Align) % kBf16Align;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + depth * P::slot);
  uint64_t* empty = full + depth;
  const int kt = k / kBf16K, rows = m / BM, strips = (n + BN - 1) / BN;
  const int tiles = n_e * strips * rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    fence_mbar_init();
  }
  __syncthreads();
  int s = 0;
  uint32_t phase = 0;   // the parity of slot s's current round
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const BatchedTile tl = batched_tile(t, rows, strips, BM, BN);
      const int ay = tl.e * m + tl.row0, by = tl.e * k;
      const int halves = (n - tl.col0 < BN ? n - tl.col0 : BN) / 64;   // B's boxes
      for (int i = 0; i < kt; ++i) {
        mbar_wait_bounded(empty + s, phase ^ 1);
        char* slot = ring + s * P::slot;
        mbar_expect_tx(full + s, P::a_tile + halves * kBf16BHalf);
        tma_load_2d(slot, amap, i * kBf16K, ay, full + s);
        for (int h = 0; h < halves; ++h)
          tma_load_2d(slot + P::a_tile + h * kBf16BHalf, bmap, tl.col0 + 64 * h,
                      by + i * kBf16K, full + s);
        if (++s == depth) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  BatchedBody<BM, BN> body;
  body.init(threadIdx.x / 128 - 1);
  const bool signal = threadIdx.x % 128 == 0;   // a consumer warpgroup's arrival
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const BatchedTile tl = batched_tile(t, rows, strips, BM, BN);
    body.zero();
    for (int i = 0; i < kt; ++i) {
      mbar_wait_bounded(full + s, phase);
      body.issue(smem_u32(ring + s * P::slot));
      wgmma_wait_all();
      body.hold();
      if (signal) mbar_arrive(empty + s);
      if (++s == depth) {
        s = 0;
        phase ^= 1;
      }
    }
    if (tl.col0 + body.col0() < n)
      body.drain(c + (static_cast<long long>(tl.e) * m + tl.row0) * n + tl.col0, n);
  }
}

template <int S, int A, int O, int BM>
__global__ void __launch_bounds__(S == TMA ? kBatchedTmaThreads : kThreads,
                                  S != TMA && BM == 128 ? 2 : 1)
matmul_bf16_batched_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b, float* c, int n_e,
                           int m, int k, int n, int depth,
                           const __grid_constant__ CUtensorMap amap,
                           const __grid_constant__ CUtensorMap bmap) {
  if constexpr (S == TMA) {
    batched_tma<BM>(&amap, &bmap, c, n_e, m, k, n, depth);
  } else {
    using P = BatchedShape<BM, MM_BN>;
    const int rows = m / BM, strips = n / MM_BN, tiles = n_e * strips * rows;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const BatchedTile tl = batched_tile(t, rows, strips, BM, MM_BN);
      const long long first = static_cast<long long>(tl.e) * m + tl.row0;   // A's row
      const char* ga = reinterpret_cast<const char*>(a + first * k);
      const char* gb =
          reinterpret_cast<const char*>(b + static_cast<long long>(tl.e) * k * n + tl.col0);
      Operand op[P::MI + 2];
#pragma unroll
      for (int i = 0; i < P::MI; ++i)
        op[i] = {ga + 256LL * k * i, 2LL * k, 2 * kBf16K, 128, 128, 128};
      op[P::MI] = {gb, 2LL * n, 2LL * kBf16K * n, kBf16K, 128, 128};
      op[P::MI + 1] = {gb + 128, 2LL * n, 2LL * kBf16K * n, kBf16K, 128, 128};
#pragma unroll
      for (int i = 0; i < P::MI + 2; ++i) op[i].swizzle128 = true;
      BatchedBody<BM, MM_BN> body;
      body.init(threadIdx.x / 128);
      run_pipeline<S, A, O>(body, op, op[0], k / kBf16K, depth);
      body.drain(c + first * n + tl.col0, n);
    }
  }
}

// Non-DROP_OFF: the columns in kF32Wide tiles, then, when n % 256 == 128,
// the last 128 columns as a second launch of the BN = MM_BN body on the
// same stream.  DROP_OFF: one launch of MM_BN tiles (its registers hold a
// slot's share beside the sums).  kernels/matmul.py (f32_launch_plan)
// counts the launches by the same rule.
struct MatmulF32Launch {
  static constexpr bool kTileOutput = false;
  const void *a, *b;
  void* c;
  int m, k, n, depth, smem;
  cudaStream_t stream;

  // Columns col_base .. col_base + cols - 1 in tiles of BN.
  template <int S, int A, int O, int BN>
  cudaError_t launch(int col_base, int cols) const {
    using P = MmF32Shape<S, BN>;
    if (k % P::kc || smem < mm_f32_smem<S, BN>(depth)) return kNotBuilt;
    CUtensorMap amap{}, bmap{};
    cudaError_t e = cudaSuccess;
    if constexpr (S == TMA) {
      e = encode_tensor_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, k, m, 4ull * k,
                               P::kc, MM_BM, CU_TENSOR_MAP_SWIZZLE_128B);
      if (e == cudaSuccess)
        e = encode_tensor_map_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, b, n, k, 4ull * n, BN,
                                 P::kc, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (e != cudaSuccess) return e;
    }
    auto kernel = matmul_f32_kernel<S, A, O, BN>;
    if ((e = ensure_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<dim3(m / MM_BM, cols / BN), kThreads, smem, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), k,
        n, col_base, depth, amap, bmap);
    return cudaGetLastError();
  }

  template <int S, int A, int O>
  cudaError_t run() const {
    int wide = 0;
    if constexpr (S != DROP_OFF) {
      wide = n / kF32Wide * kF32Wide;
      if (wide > 0) {
        const cudaError_t e = launch<S, A, O, kF32Wide>(0, wide);
        if (e != cudaSuccess) return e;
      }
    }
    return n > wide ? launch<S, A, O, MM_BN>(wide, n - wide) : cudaSuccess;
  }
};

struct MatmulBf16Launch {
  static constexpr bool kTileOutput = false;
  const void *a, *b;
  void* c;
  int m, k, n, depth, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    const int need = kBf16Align + (S == SYNC ? 1 : depth) * kBf16Slot + (S == TMA ? 8 * depth : 0);
    if (k % kBf16K || smem < need) return kNotBuilt;
    CUtensorMap amap{}, bmap{};
    cudaError_t e = cudaSuccess;
    if constexpr (S == TMA) {
      e = encode_tensor_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, k, m, 2ull * k,
                               kBf16K, MM_BM, CU_TENSOR_MAP_SWIZZLE_128B);
      if (e == cudaSuccess)
        e = encode_tensor_map_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, n, k, 2ull * n,
                                 64, kBf16K, CU_TENSOR_MAP_SWIZZLE_128B);
      if (e != cudaSuccess) return e;
    }
    auto kernel = matmul_bf16_kernel<S, A, O>;
    if ((e = ensure_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<dim3(m / MM_BM, n / MM_BN), kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(c), k, n, depth, amap, bmap);
    return cudaGetLastError();
  }
};

// E experts in one persistent launch of min(tiles, SMs x blocks an SM)
// blocks, tiles of 256 rows where Mp % 256 == 0, else 128.  Shared memory:
// [1024 for the ring base's rounding][ring][TMA: depth full, then depth
// empty mbarriers].  TMA runs at A = depth - 1 only (the ring sets the
// producer's lead), and at a ring of 2 slots or more.
struct MatmulBf16BatchedLaunch {
  static constexpr bool kTileOutput = false;
  const void *a, *b;
  void* c;
  int e, m, k, n, depth, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    return m % 256 == 0 ? launch<S, A, O, 256>() : launch<S, A, O, 128>();
  }

  template <int S, int A, int O, int BM>
  cudaError_t launch() const {
    constexpr int BN = kBatchedCols<S, BM>;
    using P = BatchedShape<BM, BN>;
    const int need = kBf16Align + (S == SYNC ? 1 : depth) * P::slot + (S == TMA ? 16 * depth : 0);
    const long long tiles = static_cast<long long>(e) * (m / BM) * ((n + BN - 1) / BN);
    if (k % kBf16K || smem < need || tiles >= (1LL << 31) || (S == TMA && A != depth - 1))
      return kNotBuilt;
    CUtensorMap amap{}, bmap{};
    cudaError_t err = cudaSuccess;
    if constexpr (S == TMA) {
      err = encode_tensor_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, k,
                                 static_cast<uint64_t>(e) * m, 2ull * k, kBf16K, BM,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
      if (err == cudaSuccess)
        err = encode_tensor_map_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, n,
                                   static_cast<uint64_t>(e) * k, 2ull * n, 64, kBf16K,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != cudaSuccess) return err;
    }
    auto kernel = matmul_bf16_batched_kernel<S, S == TMA ? 0 : A, O, BM>;
    constexpr int threads = S == TMA ? kBatchedTmaThreads : kThreads;
    if ((err = ensure_smem(kernel, smem)) != cudaSuccess) return err;
    // the blocks resident at once, SMs x blocks an SM, kept by device and
    // shared memory (the queries cost a call's host time otherwise)
    static int cached_device = -1, cached_smem = -1, most = 0;
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if (device != cached_device || smem != cached_smem) {
      int sms = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                               smem)) != cudaSuccess)
        return err;
      most = sms * per_sm;
      cached_device = device;
      cached_smem = smem;
    }
    if (most < 1) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<int>(tiles < most ? tiles : most), threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(c), e, m, k, n, depth, amap, bmap);
    return cudaGetLastError();
  }
};

}  // namespace rt

// c (m, n) f32 = a (m, k) @ b (k, n), all contiguous and 16-byte aligned;
// dtype 0 = f32, 1 = bf16 (a and b alike); m and n multiples of 128, k of the
// strategy's sub-tile (the wrapper checks bk).  Under TMA each launcher
// encodes its two tensor maps first.  One launch on `stream` (f32: one or
// two, MatmulF32Launch), no synchronisation; returns a cudaError_t.
extern "C" int matmul_launch(int device, int strategy, int ahead, int depth, int dtype,
                             const void* a, const void* b, void* c, int m, int k, int n,
                             int smem, void* stream) {
  if (m < 1 || k < 1 || n < 1 || m % rt::MM_BM || n % rt::MM_BN || !rt::aligned16(a) ||
      !rt::aligned16(b) || !rt::aligned16(c))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rt::dispatch(strategy, ahead, 0,
                        rt::MatmulF32Launch{a, b, c, m, k, n, depth, smem, s});
  if (dtype == 1)
    return rt::dispatch(strategy, ahead, 0,
                        rt::MatmulBf16Launch{a, b, c, m, k, n, depth, smem, s});
  return rt::kNotBuilt;
}

// c (e, m, n) f32 = a (e, m, k) @ b (e, k, n) expert by expert, bf16 stacks,
// all contiguous and 16-byte aligned; m and n multiples of 128, k of 64, e at
// most 65,535, e m and e k under 2^31 (TMA's coordinates) and so are the
// tiles.  One launch on `stream` (MatmulBf16BatchedLaunch), no
// synchronisation; returns a cudaError_t.
extern "C" int matmul_batched_launch(int device, int strategy, int ahead, int depth,
                                     const void* a, const void* b, void* c, int e, int m,
                                     int k, int n, int smem, void* stream) {
  if (e < 1 || e > 65535 || m < 1 || k < 1 || n < 1 || m % rt::MM_BM || n % rt::MM_BN ||
      static_cast<long long>(e) * m >= (1LL << 31) ||
      static_cast<long long>(e) * k >= (1LL << 31) || !rt::aligned16(a) || !rt::aligned16(b) ||
      !rt::aligned16(c))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return rt::dispatch(strategy, ahead, 0,
                      rt::MatmulBf16BatchedLaunch{a, b, c, e, m, k, n, depth, smem,
                                                  static_cast<cudaStream_t>(stream)});
}
