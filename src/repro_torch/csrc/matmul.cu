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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// A wgmma shared-memory matrix descriptor, SWIZZLE_128B: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmmas that own them.
__device__ __forceinline__ void hold_registers(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 f32 a thread) += A B for one m64n128k16 step, f32 accumulators,
// bf16 operands: A and B from shared-memory descriptors, A K-major, B
// MN-major (imm-trans-b = 1).  scale-d is 1: d accumulates.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
// The same with A from registers: each warp's m16n8k16 A fragment of its
// 16 rows of the warpgroup's 64.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
      wgmma_ss(acc, sw128_desc(a + 32 * s, 16, 1024), b_desc(in, s));
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
    for (int s = 0; s < kBf16K / 16; ++s) wgmma_rs(acc, fa[s], b_desc(held, s));
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
