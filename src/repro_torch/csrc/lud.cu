// Rodinia LUD for Hopper: blocked LU factorisation without pivoting, f32,
// in place on one (n, n) row-major matrix.  The kernels:
//
//   lud_diagonal       A_kk = L_kk U_kk           (Doolittle, unit L)
//   lud_perimeters     U_kj = L_kk^-1 A_kj        (the block row right of A_kk)
//                      L_ik = A_ik U_kk^-1        (the block column below A_kk)
//                      in one launch, or either alone
//   lud_internal       A_ij -= L_ik U_kj          (K = bs: inside a panel,
//                                                  both regions in one launch)
//   lud_internal_panel A_ij -= L_ip U_pj          (K = kPanel: the trailing matrix)
//
// Replaces src/repro/kernels/lud.py: lud_diagonal (line 43), lud_perimeter_row
// (line 65), lud_perimeter_col (line 96), lud_internal (line 152, both bodies);
// the host loop lud_pallas (line 188), which runs under jax.jit as one
// program, is lud_launch below: one C call enqueues every launch on the
// stream.
//
// The schedule is blocked LU with a kPanel-wide panel, not the reference's
// rank-bs update at every step.  A rank-bs update reads and writes the whole
// trailing matrix each step: at n = 8192, bs = 32 that is 8 sum_k (32 k)^2 =
// 45.5 GB, 13.6 ms at 3.35 TB/s.  With a 128-wide panel the trailing matrix
// moves 4x less (11.2 GB) and its update does 32 flops a byte, above the
// card's f32 balance of 20, so the FFMA rate bounds it.  For the panel at
// column p, of width b = min(kPanel, n - p), sub-step j at column c = p + j bs:
//
//   1. lud_diagonal at (c, c);
//   2. lud_perimeters: the row solve on rows c..c+bs, columns c+bs..n, and
//      the column solve on rows c+bs..n, columns c..c+bs, in one launch;
//   3. lud_internal (K = bs), in one launch, on rows c+bs..n, the panel's
//      columns c+bs..p+b, and on the panel's rows c+bs..p+b, columns p+b..n;
//
// then lud_internal_panel (K = b) on A[p+b:, p+b:] with L = A[p+b:, p:p+b]
// and U = A[p:p+b, p+b:].  Only a panel with columns right of it has a
// trailing update, so that update always runs at K = kPanel.  The same LU
// as the reference's loop; only the order of the rounding differs.
//
// In place: each launch reads only what earlier launches of the stream
// wrote, and writes a region that no other launch of its sub-step reads or
// writes (2's two strips are disjoint and it reads only the diagonal
// block; 3's two regions write disjoint column ranges, and neither writes
// an L or U it reads).  The K = bs body reads each C tile before it
// writes it.  The panel body never reads C on the SM: it adds -L U to it,
// one block a tile, and its C (the trailing matrix) is disjoint from its L
// and U.
#include <algorithm>

#include "async_pipeline.cuh"

namespace rt {

constexpr int kDiagThreads = 32;
constexpr int kPanel = 128;        // the panel width; PANEL in kernels/lud.py

// Slots of the int[6] launch counts every launcher fills in; kPerimeters
// is both perimeter solves in one launch.
enum LudKernel {
  kDiagonal, kPerimeterRow, kPerimeterCol, kInternal, kInternalPanel, kPerimeters
};

// The error of the <<<>>> just before it; a launch that was enqueued adds
// one to `launched`.
inline cudaError_t counted(int* launched) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ------------------------------------------------------------ diagonal --
// Replaces lud_diagonal / _diag_kernel (lud.py:30-49).
// Bound: latency.  One (bs, bs) block, 2 bs^2 * 4 bytes and (2/3) bs^3
// flops, is far below either roofline; what costs is the chain of bs - 1
// dependent elimination steps, and one launch per bs columns puts that
// chain on the factorisation's critical path.  Design: one warp, and no
// shared memory or barrier in a step.  Lane l holds rows l + 32 q (q <
// max(1, bs/32); at bs = 16 lanes 16-31 hold none) in registers.  At step
// k the lane that holds row k, final since step k-1, hands its entries
// k..bs-1 to every lane by shuffle; each lane with rows below k divides
// its column-k entry by the pivot and updates the rest of its row.  A
// step's chain is one shuffle, one division and one FFMA: the shuffles of
// the rest of row k do not wait for the division.  A lane loads and stores
// its own rows as float4 (the block starts on 16 bytes at a pitch of a
// multiple of 4 floats), all in flight at once.
template <int BS>
__global__ void __launch_bounds__(kDiagThreads)
lud_diagonal_kernel(float* d, long long pitch) {
  constexpr int R = BS > 32 ? BS / 32 : 1;    // rows a lane holds
  constexpr unsigned kWarp = 0xffffffffu;
  const int lane = threadIdx.x;
  float r[R][BS];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
#pragma unroll
    for (int j = 0; j < BS; j += 4) {
      const float4 v = i < BS ? *reinterpret_cast<const float4*>(d + i * pitch + j)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) r[q][j + e] = lane_of(v, e);
    }
  }
#pragma unroll
  for (int k = 0; k < BS - 1; ++k) {
    const float pivot = __shfl_sync(kWarp, r[k / 32][k], k % 32);
    float l[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      l[q] = r[q][k] / pivot;
      if (lane + 32 * q > k) r[q][k] = l[q];
    }
#pragma unroll
    for (int j = k + 1; j < BS; ++j) {
      const float u = __shfl_sync(kWarp, r[k / 32][j], k % 32);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (lane + 32 * q > k) r[q][j] -= l[q] * u;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    if (i < BS) {
#pragma unroll
      for (int j = 0; j < BS; j += 4)
        *reinterpret_cast<float4*>(d + i * pitch + j) =
            make_float4(r[q][j], r[q][j + 1], r[q][j + 2], r[q][j + 3]);
    }
  }
}

// ---------------------------------------------------------- perimeters --
// Replaces lud_perimeter_row / _perim_row_kernel (lud.py:54-78), U_kj =
// L_kk^-1 A_kj on the (bs, W) strip right of the diagonal block, and
// lud_perimeter_col / _perim_col_kernel (lud.py:83-109), L_ik = A_ik
// U_kk^-1 on the (H, bs) strip below it.
// Bound: latency.  A strip is read and written once, 8 bs H bytes (1.04
// MB at H = 8160, bs = 32: 0.31 us at 3.35 TB/s), against bs^2 H flops, 4
// a byte at bs = 32; what costs is a load's latency and the chain of bs
// dependent steps of a solve, repeated at each of the n / bs steps.
// Design: both solves are one routine (perim_solve) on vectors of bs
// entries, each split over G = bs / 8 lanes of a warp, kPerimEntries = 8
// consecutive entries a lane:
//   col: x U = a for a row of the strip; lane g holds the row's columns
//        8g..8g+7, two float4 (a row is 32 G bytes: a warp moves 32 / G
//        whole rows);
//   row: L y = b for a column of the strip, the same solve against L^T;
//        lane g holds rows 8g..8g+7 of one column (eight loads of a float,
//        32 / G neighbouring columns a warp: 32-byte pieces of a row).
// Each entry has a sum of its earlier terms, from 0.  Step c: every lane
// forms its entry i = c % 8 less its sum (col: times 1 / U_cc, which the
// block computed once; row: the unit diagonal), the lane that holds entry
// c hands that to its group by __shfl_sync, and every lane adds its
// multiple to its eight sums with coefficients m[c][8g..8g+7], two float4
// from shared memory, zero where the entry is not past c.  A step's chain
// is a subtraction, a multiply, a shuffle and an FFMA, with no division.
// After step c an entry's sum gains only exact zeros, so every entry is
// finished after the loop, again as its input less its sum (times 1 /
// U_cc): the value the step formed.  The sums meet the input once, as the
// plain versions' do: subtracted from the input at every step
// (right-looking), the same terms round at the input's size, and at bs =
// 64 the error against float64 was 6.9 times the plain version's (the CPU
// replay in tests/test_torch_lud.py), not 1.6.
// Eight entries a lane, not four: a lane's step costs the same subtraction,
// multiply and shuffle whatever its entries, and at four the fused launch
// at h = w = 8160 was issue-bound (5.0 us against 2.2 us at h = w = 1024,
// measured on one H100).  A lane issues all its loads (its
// entries, its share of the diagonal block) before it uses any.  A block
// stages the diagonal block once: m = U above its diagonal (col) or L^T
// above it (row: written transposed; rows padded by 4 floats, so 4 ways
// of bank conflict, not 32).  kPerimThreads a block, 256 / G vectors;
// lud_perimeters_kernel runs both strips in one launch, the row strip's
// blocks first, and each block takes its part by blockIdx; a strip of
// width or height 0 has no blocks, so the same kernel runs either solve
// alone.
constexpr int kPerimThreads = 256;
constexpr int kPerimEntries = 8;   // entries of a vector a lane holds

template <int BS>
struct __align__(16) PerimSmem {
  float m[BS][BS + 4];   // m[c][j]: entry c's coefficient in entry j (j > c), else 0
  float rcp[BS];         // col: 1 / U[c][c]
};

// Vectors of bs entries a block of kPerimThreads.
__host__ __device__ constexpr int perim_per_block(int bs) {
  return kPerimThreads * kPerimEntries / bs;
}

template <int BS, bool kRow>
__device__ __forceinline__ void perim_stage(const float* d, long long dpitch, PerimSmem<BS>& sm) {
  constexpr int kEach = BS * BS / kPerimThreads;
  static_assert(kEach * kPerimThreads == BS * BS, "the block stages whole diagonal blocks");
  float v[kEach];
#pragma unroll
  for (int q = 0; q < kEach; ++q) {
    const int e = threadIdx.x + q * kPerimThreads;
    v[q] = d[(e / BS) * dpitch + e % BS];
  }
  float diag = 1.0f;
  if (!kRow && threadIdx.x < BS) diag = d[threadIdx.x * (dpitch + 1)];
#pragma unroll
  for (int q = 0; q < kEach; ++q) {
    const int e = threadIdx.x + q * kPerimThreads, r = e / BS, c = e % BS;
    if (kRow)
      sm.m[c][r] = r > c ? v[q] : 0.0f;
    else
      sm.m[r][c] = c > r ? v[q] : 0.0f;
  }
  if (!kRow && threadIdx.x < BS) sm.rcp[threadIdx.x] = 1.0f / diag;
}

// The solve of one vector, whose entries 8g..8g+7 are x (in: the input,
// out: the solution); kUnit: a unit diagonal (row), else the reciprocals
// in sm.rcp (col).
template <int BS, bool kUnit>
__device__ __forceinline__ void perim_solve(float (&x)[kPerimEntries], const PerimSmem<BS>& sm,
                                            int g) {
  constexpr int E = kPerimEntries, G = BS / E;
  float r[E], sum[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    r[k] = kUnit ? 1.0f : sm.rcp[E * g + k];
    sum[k] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < BS; ++c) {
    const int i = c % E;
    const float v = kUnit ? x[i] - sum[i] : (x[i] - sum[i]) * r[i];
    const float xc = __shfl_sync(0xffffffffu, v, c / E, G);
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      const float4 u = *reinterpret_cast<const float4*>(&sm.m[c][E * g + k]);
      sum[k] += xc * u.x;
      sum[k + 1] += xc * u.y;
      sum[k + 2] += xc * u.z;
      sum[k + 3] += xc * u.w;
    }
  }
#pragma unroll
  for (int k = 0; k < E; ++k) x[k] = kUnit ? x[k] - sum[k] : (x[k] - sum[k]) * r[k];
}

// Block `blk` of the row strip (bs, w) at pitch spitch.
template <int BS>
__device__ __forceinline__ void perim_row_part(const float* d, long long dpitch, float* s,
                                               long long spitch, int w, int blk,
                                               PerimSmem<BS>& sm) {
  constexpr int E = kPerimEntries;
  const int g = threadIdx.x % (BS / E);
  const int j = blk * perim_per_block(BS) + threadIdx.x / (BS / E);
  float* at = s + E * g * spitch + j;
  float x[E];
#pragma unroll
  for (int k = 0; k < E; ++k) x[k] = j < w ? at[k * spitch] : 0.0f;
  perim_stage<BS, true>(d, dpitch, sm);
  __syncthreads();
  perim_solve<BS, true>(x, sm, g);
  if (j < w) {
#pragma unroll
    for (int k = 0; k < E; ++k) at[k * spitch] = x[k];
  }
}

// Block `blk` of the column strip (h, bs) at pitch spitch (s on 16 bytes,
// spitch a multiple of 4).
template <int BS>
__device__ __forceinline__ void perim_col_part(const float* d, long long dpitch, float* s,
                                               long long spitch, int h, int blk,
                                               PerimSmem<BS>& sm) {
  constexpr int E = kPerimEntries;
  const int g = threadIdx.x % (BS / E);
  const int i = blk * perim_per_block(BS) + threadIdx.x / (BS / E);
  float4* at = reinterpret_cast<float4*>(s + i * spitch + E * g);
  float x[E];
#pragma unroll
  for (int k = 0; k < E; k += 4) {
    const float4 v = i < h ? at[k / 4] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[k] = v.x;
    x[k + 1] = v.y;
    x[k + 2] = v.z;
    x[k + 3] = v.w;
  }
  perim_stage<BS, false>(d, dpitch, sm);
  __syncthreads();
  perim_solve<BS, false>(x, sm, g);
  if (i < h) {
#pragma unroll
    for (int k = 0; k < E; k += 4) at[k / 4] = make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
  }
}

// The row strip's row_blocks blocks, then the column strip's (either part
// may have none: its solve alone).
template <int BS>
__global__ void __launch_bounds__(kPerimThreads)
lud_perimeters_kernel(const float* d, long long dpitch, float* row, long long rpitch, int w,
                      float* col, long long cpitch, int h, int row_blocks) {
  __shared__ PerimSmem<BS> sm;
  if (static_cast<int>(blockIdx.x) < row_blocks)
    perim_row_part<BS>(d, dpitch, row, rpitch, w, blockIdx.x, sm);
  else
    perim_col_part<BS>(d, dpitch, col, cpitch, h, blockIdx.x - row_blocks, sm);
}

// ----------------------------------------------------------- internal --
// Replaces lud_internal / _internal_kernel (lud.py:114-183) at K = bs: the
// two updates inside a panel (sub-step 3 above), in one launch.
// Bound: HBM bytes.  C is read and written once, L and U read once: at the
// first sub-step of n = 8192, bs = 32, 14.5 MB, 4.3 us at 3.35 TB/s,
// against 2 bs flops a C entry (8 a byte).  What costs is latency: the
// update runs at every sub-step, 192 times a call there, mostly a few us
// each, so a block's loads have to be in flight together and the grid has
// to fill the card at once.
//
// Design: the sub-step's two regions, whose C are disjoint and whose L and
// U neither writes, are one grid: the tall region (rows c1..n, the panel's
// columns c1..end) first, then the wide one (the panel's rows c1..end,
// columns end..n).  In both one side of C is m = end - c1 <= kPanel - bs,
// so a block keeps that side whole and streams the other in tiles of
// kLudTile:
//   tall: C tiles of kLudTile rows x m, with their L rows (kLudTile x bs),
//         under U (bs x m), which stays resident;
//   wide: C tiles of m rows x kLudTile columns, with their U columns (bs x
//         kLudTile), beside L (m x bs), which stays resident.
// The tiles of a block stream through run_pipeline under the strategy and
// drain through its out ring, under every strategy as one tensor-map store
// of the tile's C box (row stores would cost the SM's TMA unit a request a
// row, 96 a wide tile at bs = 32, in one thread).  The resident operand is
// issued with the first ring slots, by the strategy's own means: cp.async
// chunks that
// join run_pipeline's first commit group (REGISTER_BYPASS, OVERLAP,
// DROP_OFF), one box on an mbarrier of its own that a thread waits on
// before its first read (TMA), or float4 loads all issued before their
// stores (SYNC, whose tile loads follow).  A block takes `tiles`
// consecutive tiles; the launcher picks `tiles` so that the grid keeps
// about two blocks an SM (its SM count, read once per C call), at most
// kMaxTiles a block.  A ragged last tile (a multiple of 4 rows or columns)
// is a block of its own; its copies cover its own rows and columns (TMA:
// zeros past the region), and its store is clipped at the region's edge.
//
// Shared memory: run_pipeline's [ring][out ring][TMA mbarriers], then the
// resident's mbarrier (TMA), then at the next 128 bytes the resident
// operand, dense.  A slot is [L or U tile][C tile], 128 (bs + m) bytes, an
// output tile 128 m, the resident 4 bs m: at bs = 32, depth 4 and out_depth
// 4, 124 KB; at depth 2 and out_depth 2, 68 KB (three blocks an SM by
// shared memory; __launch_bounds__ asks for two).
//
// Threads and rounding: a thread owns 4 rows x 4 columns of a C tile and
// every output is c - sum_k l u with the sum from 0 in k order, as
// lud_internal_plain's c - l @ u (a sum started at C loses the low bits of
// its terms against C's diagonal; see the panel body).  Per 4 k a thread
// reads 4 float4 of L (a row's k .. k + 3; one address for each 8 lanes)
// and 4 float4 of U (its columns; 128 or more contiguous bytes a warp)
// for 64 FMAs, with k unrolled by 16 (bs is a multiple of 16):
//   tall: warp w owns rows 4w..4w+3, lane j columns 4j..4j+3 (lanes past m
//         / 4 idle: 8 of 32 at m = 96);
//   wide: warp w and lane j own rows 16w + 4(j / 8) .. +3 and columns
//         4(j % 8) .. +3 (warps past m / 16 idle: 2 of 8 at m = 96).
// (A wide thread that owned one column of 12 rows would make 16 reads of
// shared memory, 12 of them float4, for 48 FMAs, not 8 for 64.)  DROP_OFF
// holds its own 4 x 4 of C and spreads the streamed operand over a warp's
// lanes in registers (tall: lane j holds k = j and j + 32 of each of the
// warp's 4 L rows; wide: lane j holds U[k][j] for every k), each value
// reaching the lanes that need it by __shfl_sync.  Every body reads other
// threads' copies: kCrossThreadReads.
constexpr int kLudTile = 32;       // TILE in kernels/lud.py
constexpr int kLudMaxBs = 64;
constexpr int kMaxTiles = 8;

static_assert(kThreads == 256 && kPanel - 16 <= 4 * 32 && kPanel - 16 <= 16 * 8,
              "tall: 8 warps of 4 rows, 4 columns a lane; wide: 8 warps of 16 rows");

// One region, C (h, w) -= L (h, bs) U (bs, w); `blocks` of the grid.
struct LudRegion {
  const float *l, *u;
  float* c;
  long long lpitch, upitch, cpitch;
  int h, w, blocks;
};

// Bytes before the resident operand: the ring (SYNC: one slot), the out
// ring, TMA's mbarriers and the resident's, at the next 128 bytes (a TMA
// box lands on 128; every slot and output tile is a multiple of 128).
__host__ __device__ constexpr int lud_resident_offset(int s, int out_depth, int depth, int bs,
                                                      int m) {
  return ((s == SYNC ? 1 : depth) * kLudTile * (bs + m) * 4 + out_depth * kLudTile * m * 4 +
          (s == TMA ? 8 * depth + 8 : 0) + 127) & ~127;
}

__host__ __device__ constexpr int lud_internal_smem(int s, int out_depth, int depth, int bs,
                                                    int m) {
  return lud_resident_offset(s, out_depth, depth, bs, m) + 4 * bs * m;
}

// kTall: L streams (the slot's first tile, rows x bs) under the resident U
// (bs x m); else U streams (bs x kLudTile) beside the resident L (m x bs).
// C's tile follows the streamed one in the slot, `cols` wide.
template <bool kTall>
struct LudBody {
  static constexpr bool kCrossThreadReads = true;
  int bs, rows, cols, cofs, r0, c0, lane;   // cofs: bytes from a slot to its C tile
  bool active;                              // the thread has rows and columns
  const float* res;                         // the resident operand
  uint64_t* rbar;                           // TMA: the resident's mbarrier, until waited on
  float sh[kTall ? 8 : kLudMaxBs];          // DROP_OFF: the streamed operand, spread
  float4 cv[4];                             // DROP_OFF: C[r0 + i][c0 .. c0 + 3]

  __device__ __forceinline__ void wait_resident() {
    if (rbar != nullptr) {
      mbar_wait(rbar, 0);
      rbar = nullptr;
    }
  }
  __device__ __forceinline__ const float* l_of(const char* in) const {
    return kTall ? reinterpret_cast<const float*>(in) : res;
  }
  __device__ __forceinline__ const float* u_of(const char* in) const {
    return kTall ? res : reinterpret_cast<const float*>(in);
  }
  __device__ __forceinline__ float4 l4(const float* l, int i, int k) const {
    return *reinterpret_cast<const float4*>(l + (r0 + i) * bs + k);
  }
  __device__ __forceinline__ float4 u4(const float* u, int k) const {
    return *reinterpret_cast<const float4*>(u + k * cols + c0);
  }
  __device__ __forceinline__ float4 c4(const char* in, int i) const {
    return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(in + cofs) +
                                            (r0 + i) * cols + c0);
  }
  // acc += l[:, kk] (x) v for the thread's 4 rows
  __device__ __forceinline__ void rank1(float (&acc)[4][4], const float4 (&l)[4], int kk,
                                        float4 v) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = lane_of(l[i], kk);
      acc[i][0] += x * v.x;
      acc[i][1] += x * v.y;
      acc[i][2] += x * v.z;
      acc[i][3] += x * v.w;
    }
  }
  __device__ __forceinline__ void put(char* out, int i, float4 c, const float (&a)[4]) const {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + (r0 + i) * cols + c0) =
        make_float4(c.x - a[0], c.y - a[1], c.z - a[2], c.w - a[3]);
  }
  __device__ __forceinline__ void compute(const char* in, char* out) {
    wait_resident();
    if (!active) return;
    const float *L = l_of(in), *U = u_of(in);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < bs; k0 += 16) {
#pragma unroll
      for (int k = k0; k < k0 + 16; k += 4) {
        float4 l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] = l4(L, i, k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) rank1(acc, l, kk, u4(U, k + kk));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < rows) put(out, i, c4(in, i), acc[i]);
  }
  __device__ __forceinline__ void load(const char* in) {
    if constexpr (kTall) {   // lane j: k = j and j + 32 of each of the warp's L rows
      const float* L = l_of(in);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          sh[2 * i + q] = lane + 32 * q < bs ? L[(r0 + i) * bs + lane + 32 * q] : 0.0f;
    } else {       // lane j: column j of every U row
      const float* U = u_of(in);
#pragma unroll
      for (int k = 0; k < kLudMaxBs; ++k)
        if (k < bs) sh[k] = U[k * cols + lane];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (active && r0 + i < rows) cv[i] = c4(in, i);
  }
  __device__ __forceinline__ void store(char* out) {
    constexpr unsigned kWarp = 0xffffffffu;
    float acc[4][4] = {};
#pragma unroll
    for (int k = 0; k < kLudMaxBs; k += 4) {
      if (k < bs) {   // every lane takes part in the shuffles
        float4 l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kTall) {
            const int src = k % 32, q = k / 32;
            l[i] = make_float4(__shfl_sync(kWarp, sh[2 * i + q], src),
                               __shfl_sync(kWarp, sh[2 * i + q], src + 1),
                               __shfl_sync(kWarp, sh[2 * i + q], src + 2),
                               __shfl_sync(kWarp, sh[2 * i + q], src + 3));
          } else {
            l[i] = active ? l4(res, i, k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 v;
          if constexpr (kTall) {
            v = active ? u4(res, k + kk) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          } else {
            v = make_float4(__shfl_sync(kWarp, sh[k + kk], c0),
                            __shfl_sync(kWarp, sh[k + kk], c0 + 1),
                            __shfl_sync(kWarp, sh[k + kk], c0 + 2),
                            __shfl_sync(kWarp, sh[k + kk], c0 + 3));
          }
          rank1(acc, l, kk, v);
        }
      }
    }
    if (!active) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < rows) put(out, i, cv[i], acc[i]);
  }
};

// SYNC's resident copy: every float4 load of the thread, then the stores
// (at most kResidentChunks a thread: bs m <= 64 x 64 floats).
constexpr int kResidentChunks = 4;

__device__ __forceinline__ void resident_sync(const Operand& r, char* dst) {
  const int cpr = r.row_bytes >> 4;
  uint4 v[kResidentChunks];
#pragma unroll
  for (int j = 0; j < kResidentChunks; ++j) {
    const int e = threadIdx.x + j * kThreads, row = e / cpr;
    if (e < r.chunks())
      v[j] = *reinterpret_cast<const uint4*>(r.g + row * r.gpitch + (e - row * cpr) * 16);
  }
#pragma unroll
  for (int j = 0; j < kResidentChunks; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < r.chunks()) *reinterpret_cast<uint4*>(dst + e * 16) = v[j];
  }
}

// Block `blk` of region `r`: the tall region (kTall: U resident, rows
// streamed) or the wide one (L resident, columns streamed).  lmap, umap,
// cmap: the region's tensor maps (TMA).
template <int S, int A, int O, bool kTall>
__device__ __forceinline__ void lud_region(const LudRegion& r, int blk, int bs, int tiles,
                                           int depth, const CUtensorMap* lmap,
                                           const CUtensorMap* umap, const CUtensorMap* cmap) {
  const int m = kTall ? r.w : r.h;             // the side a block keeps whole
  const int extent = kTall ? r.h : r.w;        // the side it streams
  const int nf = extent / kLudTile;            // full tiles
  int j0 = blk * tiles, n_tiles = min(tiles, nf - j0), part = kLudTile;
  if (j0 >= nf) {                              // the ragged last tile
    j0 = nf;
    n_tiles = 1;
    part = extent - nf * kLudTile;
  }
  const long long at = static_cast<long long>(j0) * kLudTile;   // first row or column
  const int ring = (S == SYNC ? 1 : depth) * kLudTile * (bs + m) * 4;
  uint64_t* rbar = reinterpret_cast<uint64_t*>(smem + ring + O * kLudTile * m * 4 + 8 * depth);
  char* resident = smem + lud_resident_offset(S, O, depth, bs, m);
  // the streamed operands (row copies; under TMA whole boxes) and the resident
  Operand op[2], res[1];
  if constexpr (kTall) {
    op[0] = {reinterpret_cast<const char*>(r.l + at * r.lpitch), 4 * r.lpitch,
             4LL * kLudTile * r.lpitch, part, 4 * bs, 4 * bs};
    op[1] = {reinterpret_cast<const char*>(r.c + at * r.cpitch), 4 * r.cpitch,
             4LL * kLudTile * r.cpitch, part, 4 * m, 4 * m};
    res[0] = {reinterpret_cast<const char*>(r.u), 4 * r.upitch, 0, bs, 4 * m, 4 * m};
  } else {
    op[0] = {reinterpret_cast<const char*>(r.u + at), 4 * r.upitch, 4 * kLudTile, bs, 4 * part,
             4 * kLudTile};
    op[1] = {reinterpret_cast<const char*>(r.c + at), 4 * r.cpitch, 4 * kLudTile, m, 4 * part,
             4 * kLudTile};
    res[0] = {reinterpret_cast<const char*>(r.l), 4 * r.lpitch, 0, m, 4 * bs, 4 * bs};
  }
  // the write-back, under every strategy: C's box (the whole tile; the
  // store is clipped at the region's edge)
  OutTile out = op[1];
  out.map = cmap;
  if constexpr (kTall) {
    out.y0 = static_cast<int>(at);
    out.dy = out.rows = kLudTile;
  } else {
    out.x0 = static_cast<int>(at);
    out.dx = kLudTile;
  }
  if constexpr (S == TMA) {   // boxes: tall at (0, at + 32 i), wide at (at + 32 i, 0)
    op[0].map = kTall ? lmap : umap;
    op[1].map = cmap;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      Operand& o = op[k];
      if constexpr (kTall) {
        o.y0 = static_cast<int>(at);
        o.dy = kLudTile;
        o.rows = kLudTile;
      } else {
        o.x0 = static_cast<int>(at);
        o.dx = kLudTile;
        o.row_bytes = 4 * kLudTile;
      }
    }
    if (threadIdx.x == 0) {
      mbar_init(rbar, 1);
      fence_mbar_init();
      fence_proxy_async();
      mbar_expect_tx(rbar, res[0].rows * res[0].row_bytes);
      tma_load_2d(resident, kTall ? umap : lmap, 0, 0, rbar);
    }
  } else if constexpr (S == SYNC) {
    resident_sync(res[0], resident);
  } else {   // no commit: the chunks join run_pipeline's first group
    issue_cp_async(res, 0, resident);
  }
  LudBody<kTall> body;
  body.bs = bs;
  body.lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if constexpr (kTall) {
    body.rows = op[1].rows;
    body.cols = m;
    body.r0 = 4 * warp;
    body.c0 = 4 * body.lane;
  } else {
    body.rows = m;
    body.cols = kLudTile;
    body.r0 = 16 * warp + 4 * (body.lane / 8);
    body.c0 = 4 * (body.lane % 8);
  }
  body.active = body.r0 < body.rows && body.c0 < body.cols;
  body.cofs = op[0].tile_bytes();
  body.res = reinterpret_cast<const float*>(resident);
  body.rbar = S == TMA ? rbar : nullptr;
  run_pipeline<S, A, O>(body, op, out, n_tiles, depth);
}

template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads, 2)
lud_internal_kernel(const LudRegion tall, const LudRegion wide, int bs, int tiles, int depth,
                    const __grid_constant__ CUtensorMap tall_l,
                    const __grid_constant__ CUtensorMap tall_u,
                    const __grid_constant__ CUtensorMap tall_c,
                    const __grid_constant__ CUtensorMap wide_l,
                    const __grid_constant__ CUtensorMap wide_u,
                    const __grid_constant__ CUtensorMap wide_c) {
  if (static_cast<int>(blockIdx.x) < tall.blocks)
    lud_region<S, A, O, true>(tall, blockIdx.x, bs, tiles, depth, &tall_l, &tall_u, &tall_c);
  else
    lud_region<S, A, O, false>(wide, blockIdx.x - tall.blocks, bs, tiles, depth, &wide_l,
                               &wide_u, &wide_c);
}

// Both regions of a sub-step in one launch (either may be empty: h or w 0).
struct LudInternalLaunch {
  LudRegion tall, wide;
  int bs, depth, smem, sms;
  int* launched;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    const bool has_tall = tall.h > 0 && tall.w > 0, has_wide = wide.h > 0 && wide.w > 0;
    const int m = std::max(has_tall ? tall.w : 0, has_wide ? wide.h : 0);
    if (smem < lud_internal_smem(S, O, depth, bs, m)) return kNotBuilt;
    // tall L, U, C, wide L, U, C: L (h, bs), U (bs, w), C (h, w), in boxes
    // of the streamed tiles and the resident whole; C's (the write-back)
    // under every strategy, L's and U's under TMA
    CUtensorMap maps[6]{};
    cudaError_t e = cudaSuccess;
    const LudRegion* rs[2] = {&tall, &wide};
    for (int t = 0; t < 2 && e == cudaSuccess; ++t) {
      const LudRegion& r = *rs[t];
      if (r.h < 1 || r.w < 1) continue;
      const bool is_tall = t == 0;
      CUtensorMap* mp = maps + 3 * t;
      e = encode_tensor_map_2d(mp + 2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, r.c, r.w, r.h,
                               4ull * r.cpitch, is_tall ? r.w : kLudTile,
                               is_tall ? kLudTile : r.h, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (S == TMA && e == cudaSuccess)
        e = encode_tensor_map_2d(mp, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, r.l, bs, r.h,
                                 4ull * r.lpitch, bs, is_tall ? kLudTile : r.h,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
      if (S == TMA && e == cudaSuccess)
        e = encode_tensor_map_2d(mp + 1, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, r.u, r.w, bs,
                                 4ull * r.upitch, is_tall ? r.w : kLudTile, bs,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    if (e != cudaSuccess) return e;
    auto kernel = lud_internal_kernel<S, A, O>;
    if ((e = ensure_smem(kernel, smem)) != cudaSuccess) return e;
    // full tiles and ragged ones of each region
    const int ft = has_tall ? tall.h / kLudTile : 0, fw = has_wide ? wide.w / kLudTile : 0;
    const int rt = has_tall && tall.h % kLudTile ? 1 : 0;
    const int rw = has_wide && wide.w % kLudTile ? 1 : 0;
    const int tiles = std::max(1, std::min(kMaxTiles, (ft + fw + 2 * sms - 1) / (2 * sms)));
    LudRegion t = tall, w = wide;
    t.blocks = has_tall ? (ft + tiles - 1) / tiles + rt : 0;
    w.blocks = has_wide ? (fw + tiles - 1) / tiles + rw : 0;
    if (t.blocks + w.blocks == 0) return cudaErrorInvalidValue;
    kernel<<<t.blocks + w.blocks, kThreads, smem, stream>>>(t, w, bs, tiles, depth, maps[0],
                                                           maps[1], maps[2], maps[3], maps[4],
                                                           maps[5]);
    return counted(launched + kInternal);
  }
};

// ----------------------------------------------------- internal, panel --
// Replaces lud_internal / _internal_kernel (lud.py:114-183) at K = kPanel:
// the trailing update after each panel, C (H, W) -= L (H, K) U (K, W).
// Bound: operations.  2 H W K flops against C read and written once and
// L and U read once: at the first panel of n = 8192, (8064, 8064, 128),
// 1.665e10 flops are 0.2488 ms at 66.91 TFLOP/s and 528.5 MB are 0.158 ms
// at 3.35 TB/s.  L and U (8.3 MB there) stay in the L2 across the launch.
// Design: the register tiling of the f32 matmul (MatmulF32Body in
// matmul.cu).  A block owns one 128 x 128 C tile; thread t holds 8 x 8
// sums, rows ty + 16 i (i < 8, ty = t / 16) and columns 4 tx .. 4 tx + 3
// and 64 + 4 tx .. 64 + 4 tx + 3 (tx = t % 16).  The K loop streams slices
// of kc rows of U and kc columns of L through run_pipeline under the
// strategy (kc = 32; DROP_OFF, which holds its share of a slot in
// registers beside the 64 sums, 4); per 4 k a thread loads 8 float4 of L
// and 8 of U for 256 FFMAs.  The sums hold the product alone, and after
// the loop -L U is added to C once, with one rounding: the plain version's
// c - l @ u.  (Sums that start at C lose the low bits of each of the 128
// products against C's diagonal, near n: on the H100 at n = 8192 the
// whole lud then departs from the plain one by 0.171, not 1.2e-7.)  The
// SM never reads C: the copy strategies add with float4 atomics (RED,
// performed in the L2; no other block touches the tile), TMA with one
// tensor-map reduction (below).  No out ring (one output tile a block),
// so the launch takes no out_depth, as the f32 matmul.
//
// A slot is [U: kc rows x 128 floats][L: 128 rows x kc floats].  Copies
// (SYNC, REGISTER_BYPASS, OVERLAP, DROP_OFF) pad every row pitch by 16
// bytes, as the f32 matmul, and copy only the block's own rows and
// columns (a ragged block leaves the rest of its slot stale; those sums
// are never written).  TMA loads each slice as two boxes from 2-D tensor
// maps: U's 128 x kc box, dense (its float4 reads are conflict-free), and
// L's kc x 128 box, whose 128-byte rows land in the 128-byte swizzle
// (chunk q of row r at r * 128 + ((q ^ (r & 7)) << 4), the ring base on
// 1024 bytes), so that the two L rows a warp reads fall in distinct banks
// without padding the box cannot have.  Boxes past the matrix land zeros.
// Its write-back goes through the freed ring: the block stages -L U there
// and one thread adds it to C's box as one tensor-map reduction
// (cp.reduce.async.bulk.tensor .add, clipped at the matrix's edge), so
// the SM never reads C: the TMA unit does, in the L2.
//
// Registers: two blocks an SM (at most 128 a thread), one for DROP_OFF.
constexpr int LP_BM = 128, LP_BN = 128;

template <int S>
struct LudPanelShape {
  static constexpr int kc = S == DROP_OFF ? 4 : 32;
  static constexpr bool swizzled = S == TMA;            // L rows of 128 B, swizzled
  static constexpr int a_pitch = swizzled ? kc * 4 : kc * 4 + 16;       // L, bytes
  static constexpr int b_pitch = swizzled ? LP_BN * 4 : LP_BN * 4 + 16;  // U, bytes
  static constexpr int slot = kc * b_pitch + LP_BM * a_pitch;
  static constexpr int align = swizzled ? 1024 : 1;
  static_assert(!swizzled || kc * 4 == 128, "the swizzle takes rows of 128 bytes");
  static_assert(kPanel % kc == 0, "K runs in whole slices");
};

// Dynamic shared memory of one panel block at ring depth `depth` (the
// kernel's layout: [ring base padding][ring][TMA mbarriers]).
template <int S>
constexpr int lud_panel_smem(int depth) {
  using P = LudPanelShape<S>;
  return (P::align > 1 ? P::align : 0) + (S == SYNC ? 1 : depth) * P::slot +
         (S == TMA ? 8 * depth : 0);
}

template <int S>
struct LudPanelBody {
  using P = LudPanelShape<S>;
  static constexpr int KC = P::kc;
  static constexpr bool kCrossThreadReads = true;
  static constexpr int kRingAlign = P::align;
  static constexpr int kA = P::a_pitch / 4;   // L row pitch, floats
  static constexpr int kB = P::b_pitch / 4;   // U row pitch, floats
  int ty, tx, sw;
  float acc[8][8];
  float4 ra[8], rb[4][2];     // DROP_OFF: this thread's L rows and U columns

  __device__ __forceinline__ void init() {
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
    sw = ty & 7;              // (ty + 16 i) & 7: the swizzle of every row it reads
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  // acc += l[:, kk] (x) (b0, b1)
  __device__ __forceinline__ void rank1(const float4 (&a)[8], int kk, float4 b0, float4 b1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = lane_of(a[i], kk);
      acc[i][0] += x * b0.x;
      acc[i][1] += x * b0.y;
      acc[i][2] += x * b0.z;
      acc[i][3] += x * b0.w;
      acc[i][4] += x * b1.x;
      acc[i][5] += x * b1.y;
      acc[i][6] += x * b1.z;
      acc[i][7] += x * b1.w;
    }
  }
  // L's columns k .. k + 3 (k % 4 == 0) of rows ty + 16 i
  __device__ __forceinline__ void load_l(const char* in, int k, float4 (&a)[8]) const {
    const char* L = in + KC * P::b_pitch;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      a[i] = P::swizzled
                 ? *reinterpret_cast<const float4*>(L + r * 128 + (((k >> 2) ^ sw) << 4))
                 : *reinterpret_cast<const float4*>(L + r * P::a_pitch + 4 * k);
    }
  }
  __device__ __forceinline__ float4 u_at(const char* in, int k, int half) const {
    return *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(in) + k * kB + 64 * half + 4 * tx);
  }
  __device__ __forceinline__ void compute(const char* in, char*) {
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 a[8];
      load_l(in, k, a);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rank1(a, kk, u_at(in, k + kk, 0), u_at(in, k + kk, 1));
    }
  }
  __device__ __forceinline__ void load(const char* in) {
    static_assert(KC == 4, "DROP_OFF holds one float4 of L per row");
    load_l(in, 0, ra);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      rb[kk][0] = u_at(in, kk, 0);
      rb[kk][1] = u_at(in, kk, 1);
    }
  }
  __device__ __forceinline__ void store(char*) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) rank1(ra, kk, rb[kk][0], rb[kk][1]);
  }
  // -L U inside the block's rows x width: added to c at cpitch (float4
  // reductions, which the L2 performs), or, given `stage` (dense 128 x
  // 128), written there
  __device__ __forceinline__ void finish(float* c, long long cpitch, int rows, int width,
                                         float* stage) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * h + 4 * tx;
        const float4 y = make_float4(-acc[i][4 * h], -acc[i][4 * h + 1], -acc[i][4 * h + 2],
                                     -acc[i][4 * h + 3]);
        if (r < rows && col < width) {
          if (stage)
            *reinterpret_cast<float4*>(stage + r * LP_BN + col) = y;
          else
            atomicAdd(reinterpret_cast<float4*>(c + r * cpitch + col), y);
        }
      }
    }
  }
};

// One thread: global box at (x, y) of `map` += the shared tile at s (f32
// add, done by the TMA unit), as one bulk group.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, int x, int y,
                                                  const void* s) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%1, %2}], [%3];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(s)) : "memory");
}

template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads, S == DROP_OFF ? 1 : 2)
lud_internal_panel_kernel(const float* l, long long lpitch, const float* u, long long upitch,
                          float* c, long long cpitch, int h, int w, int k, int depth,
                          const __grid_constant__ CUtensorMap lmap,
                          const __grid_constant__ CUtensorMap umap,
                          const __grid_constant__ CUtensorMap cmap) {
  using P = LudPanelShape<S>;
  constexpr int kc = P::kc;
  const int row0 = blockIdx.x * LP_BM, col0 = blockIdx.y * LP_BN;
  const int rows = min(LP_BM, h - row0), width = min(LP_BN, w - col0);
  Operand op[2] = {
      {reinterpret_cast<const char*>(u + col0), 4 * upitch, 4LL * kc * upitch, kc, 4 * width,
       P::b_pitch},
      {reinterpret_cast<const char*>(l + row0 * lpitch), 4 * lpitch, 4 * kc, rows, 4 * kc,
       P::a_pitch}};
  if constexpr (S == TMA) {   // whole boxes: U at (col0, kc i), L at (kc i, row0)
    op[0].map = &umap;
    op[0].x0 = col0;
    op[0].dy = kc;
    op[0].row_bytes = 4 * LP_BN;
    op[1].map = &lmap;
    op[1].dx = kc;
    op[1].y0 = row0;
    op[1].rows = LP_BM;
  }
  float* cg = c + row0 * cpitch + col0;
  LudPanelBody<S> body;
  body.init();
  run_pipeline<S, A, O>(body, op, op[0], k / kc, depth);
  if constexpr (S == TMA) {
    // run_pipeline's last barrier freed the ring and every load has landed:
    // -L U is staged at the ring base and added to C's box
    float* stage = reinterpret_cast<float*>(
        smem + (P::align - smem_u32(smem) % P::align) % P::align);
    body.finish(cg, cpitch, rows, width, stage);
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {   // the block may end once the stage is read
      tma_reduce_add_2d(&cmap, col0, row0, stage);
      bulk_commit();
      bulk_wait_read<0>();
    }
  } else {
    body.finish(cg, cpitch, rows, width, nullptr);
  }
}

struct LudPanelLaunch {
  static constexpr bool kTileOutput = false;
  const float *l, *u;
  float* c;
  long long lpitch, upitch, cpitch;
  int h, w, k, depth, smem;   // smem 0: what this strategy and depth need
  int* launched;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    using P = LudPanelShape<S>;
    const int need = lud_panel_smem<S>(depth);
    if (smem != 0 && smem < need) return kNotBuilt;
    if (S == TMA && depth * P::slot < LP_BM * LP_BN * 4) return kNotBuilt;  // the stage
    CUtensorMap lmap{}, umap{}, cmap{};
    cudaError_t e = cudaSuccess;
    if constexpr (S == TMA) {
      e = encode_tensor_map_2d(&lmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, l, k, h, 4ull * lpitch,
                               P::kc, LP_BM, CU_TENSOR_MAP_SWIZZLE_128B);
      if (e == cudaSuccess)
        e = encode_tensor_map_2d(&umap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, u, w, k,
                                 4ull * upitch, LP_BN, P::kc, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (e == cudaSuccess)
        e = encode_tensor_map_2d(&cmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, c, w, h,
                                 4ull * cpitch, LP_BN, LP_BM, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (e != cudaSuccess) return e;
    }
    auto kernel = lud_internal_panel_kernel<S, A, O>;
    const int bytes = smem != 0 ? smem : need;
    if ((e = ensure_smem(kernel, bytes)) != cudaSuccess) return e;
    const dim3 grid((h + LP_BM - 1) / LP_BM, (w + LP_BN - 1) / LP_BN);
    kernel<<<grid, kThreads, bytes, stream>>>(l, lpitch, u, upitch, c, cpitch, h, w, k, depth,
                                              lmap, umap, cmap);
    return counted(launched + kInternalPanel);
  }
};

// ------------------------------------------------------ host dispatch --

cudaError_t diagonal(int bs, float* d, long long pitch, int* launched, cudaStream_t s) {
  switch (bs) {
    case 16: lud_diagonal_kernel<16><<<1, kDiagThreads, 0, s>>>(d, pitch); break;
    case 32: lud_diagonal_kernel<32><<<1, kDiagThreads, 0, s>>>(d, pitch); break;
    case 64: lud_diagonal_kernel<64><<<1, kDiagThreads, 0, s>>>(d, pitch); break;
    default: return kNotBuilt;
  }
  return counted(launched + kDiagonal);
}

// Blocks of a strip of n vectors.
inline int perim_blocks(int bs, int n) {
  return (n + perim_per_block(bs) - 1) / perim_per_block(bs);
}

// The row strip's solve (w > 0) and the column strip's (h > 0) at block
// size BS, in one launch.
template <int BS>
void launch_perimeters(const float* d, long long dpitch, float* row, long long rpitch, int w,
                       float* col, long long cpitch, int h, cudaStream_t s) {
  const int rb = perim_blocks(BS, w);
  lud_perimeters_kernel<BS><<<rb + perim_blocks(BS, h), kPerimThreads, 0, s>>>(
      d, dpitch, row, rpitch, w, col, cpitch, h, rb);
}

// Counted in the slot of what it launched: kPerimeterRow (h == 0),
// kPerimeterCol (w == 0) or kPerimeters.
cudaError_t perimeters(int bs, const float* d, long long dpitch, float* row, long long rpitch,
                       int w, float* col, long long cpitch, int h, int* launched,
                       cudaStream_t s) {
  switch (bs) {
    case 16: launch_perimeters<16>(d, dpitch, row, rpitch, w, col, cpitch, h, s); break;
    case 32: launch_perimeters<32>(d, dpitch, row, rpitch, w, col, cpitch, h, s); break;
    case 64: launch_perimeters<64>(d, dpitch, row, rpitch, w, col, cpitch, h, s); break;
    default: return kNotBuilt;
  }
  return counted(launched + (h == 0 ? kPerimeterRow : w == 0 ? kPerimeterCol : kPerimeters));
}

// Selects `device` and reads its SM count.
cudaError_t use_device(int device, int* sms) {
  const cudaError_t e = cudaSetDevice(device);
  return e != cudaSuccess ? e
                          : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

bool card_bs(int bs) { return bs == 16 || bs == 32 || bs == 64; }

}  // namespace rt

// Every launcher returns a cudaError_t, launches on `stream` and does not
// synchronise.  Pitches are in floats.  Each works in place and adds the
// launches it enqueued to launched[6] (diagonal, perimeter row, perimeter
// column, internal at K = bs, internal at K = kPanel, both perimeters in
// one launch).

// d: the (bs, bs) block at pitch `pitch`, a multiple of 4 floats; d starts
// on 16 bytes (a lane moves its rows as float4).
extern "C" int lud_diagonal_launch(int device, int bs, void* d, int pitch, int* launched,
                                   void* stream) {
  if (!rt::card_bs(bs) || pitch < bs || pitch % 4 || !rt::aligned16(d))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::diagonal(bs, static_cast<float*>(d), pitch, launched,
                      static_cast<cudaStream_t>(stream));
}

// d: the factored (bs, bs) diagonal block; strip: (bs, w), solved in place.
extern "C" int lud_perimeter_row_launch(int device, int bs, const void* d, int dpitch,
                                        void* strip, int spitch, int w, int* launched,
                                        void* stream) {
  if (!rt::card_bs(bs) || dpitch < bs || spitch < w || w < 1) return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::perimeters(bs, static_cast<const float*>(d), dpitch, static_cast<float*>(strip),
                        spitch, w, nullptr, 0, 0, launched, static_cast<cudaStream_t>(stream));
}

// d: the factored (bs, bs) diagonal block; strip: (h, bs), solved in place,
// on 16 bytes at a pitch of a multiple of 4 floats (a lane moves a row's
// four floats as one float4).
extern "C" int lud_perimeter_col_launch(int device, int bs, const void* d, int dpitch,
                                        void* strip, int spitch, int h, int* launched,
                                        void* stream) {
  if (!rt::card_bs(bs) || dpitch < bs || spitch < bs || spitch % 4 || h < 1 ||
      !rt::aligned16(strip))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::perimeters(bs, static_cast<const float*>(d), dpitch, nullptr, 0, 0,
                        static_cast<float*>(strip), spitch, h, launched,
                        static_cast<cudaStream_t>(stream));
}

// Both solves against the factored diagonal block d in one launch: row
// (bs, w) as lud_perimeter_row_launch takes it, col (h, bs) as
// lud_perimeter_col_launch does.
extern "C" int lud_perimeters_launch(int device, int bs, const void* d, int dpitch, void* row,
                                     int rpitch, int w, void* col, int cpitch, int h,
                                     int* launched, void* stream) {
  if (!rt::card_bs(bs) || dpitch < bs || rpitch < w || w < 1 || cpitch < bs || cpitch % 4 ||
      h < 1 || !rt::aligned16(col))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::perimeters(bs, static_cast<const float*>(d), dpitch, static_cast<float*>(row),
                        rpitch, w, static_cast<float*>(col), cpitch, h, launched,
                        static_cast<cudaStream_t>(stream));
}

// Does one region, as its launcher takes it, suit the K = bs body?  l, u
// and c start on 16 bytes, every pitch and w are multiples of 4 floats
// (cp.async, the bulk copies and the tensor maps move 16-byte units).
static bool lud_region_ok(const void* l, int lpitch, const void* u, int upitch, const void* c,
                          int cpitch, int h, int w, int bs) {
  return h >= 1 && w >= 1 && w % 4 == 0 && (lpitch | upitch | cpitch) % 4 == 0 &&
         rt::aligned16(l) && rt::aligned16(u) && rt::aligned16(c) && lpitch >= bs &&
         upitch >= w && cpitch >= w;
}

static rt::LudRegion lud_region_of(const void* l, int lpitch, const void* u, int upitch, void* c,
                                   int cpitch, int h, int w) {
  return {static_cast<const float*>(l), static_cast<const float*>(u), static_cast<float*>(c),
          lpitch, upitch, cpitch, h, w, 0};
}

// c (h, w) -= l (h, bs) @ u (bs, w), c updated in place, as one region of
// the K = bs body: the tall one (U resident) if w <= kPanel - bs, else the
// wide one (L resident) if h <= kPanel - bs; any other shape is refused.
// Regions as lud_region_ok takes them; smem covers lud_internal_smem at
// kPanel - bs.  Under TMA it encodes the region's tensor maps first, as
// lud_launch does at every sub-step.
extern "C" int lud_internal_launch(int device, int strategy, int ahead, int out_depth,
                                   int depth, const void* l, int lpitch, const void* u,
                                   int upitch, void* c, int cpitch, int h, int w, int bs,
                                   int smem, int* launched, void* stream) {
  const int most = rt::kPanel - bs;
  if (!rt::card_bs(bs) || !lud_region_ok(l, lpitch, u, upitch, c, cpitch, h, w, bs) ||
      (w > most && h > most))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = rt::use_device(device, &sms);
  if (e != cudaSuccess) return e;
  const rt::LudRegion r = lud_region_of(l, lpitch, u, upitch, c, cpitch, h, w), none{};
  const bool tall = w <= most;
  return rt::dispatch(strategy, ahead, out_depth,
                      rt::LudInternalLaunch{tall ? r : none, tall ? none : r, bs, depth, smem,
                                            sms, launched, static_cast<cudaStream_t>(stream)});
}

// Both K = bs updates of a sub-step in one launch: the tall region (ht,
// wt), wt <= kPanel - bs, and the wide one (hw, ww), hw <= kPanel - bs, or
// no wide region (hw = ww = 0).  Each region as lud_internal_launch takes
// it; the two C must be disjoint and neither may overlap an L or U.
extern "C" int lud_internal_pair_launch(int device, int strategy, int ahead, int out_depth,
                                        int depth, const void* lt, int ltpitch, const void* ut,
                                        int utpitch, void* ct, int ctpitch, int ht, int wt,
                                        const void* lw, int lwpitch, const void* uw,
                                        int uwpitch, void* cw, int cwpitch, int hw, int ww,
                                        int bs, int smem, int* launched, void* stream) {
  const int most = rt::kPanel - bs;
  const bool wide = hw != 0 || ww != 0;
  if (!rt::card_bs(bs) || !lud_region_ok(lt, ltpitch, ut, utpitch, ct, ctpitch, ht, wt, bs) ||
      wt > most ||
      (wide && (!lud_region_ok(lw, lwpitch, uw, uwpitch, cw, cwpitch, hw, ww, bs) || hw > most)))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = rt::use_device(device, &sms);
  if (e != cudaSuccess) return e;
  return rt::dispatch(
      strategy, ahead, out_depth,
      rt::LudInternalLaunch{lud_region_of(lt, ltpitch, ut, utpitch, ct, ctpitch, ht, wt),
                            wide ? lud_region_of(lw, lwpitch, uw, uwpitch, cw, cwpitch, hw, ww)
                                 : rt::LudRegion{},
                            bs, depth, smem, sms, launched, static_cast<cudaStream_t>(stream)});
}

// c (h, w) -= l (h, k) @ u (k, w) on the panel body, c updated in place;
// k is kPanel, the only K of a trailing update.  l, u and c start on 16 bytes,
// their pitches and w are multiples of 4 floats; smem covers the strategy's
// ring at `depth` (lud_panel_smem).  Under TMA it encodes L's, U's and C's
// tensor maps first.  No out_depth: one output tile a block.
extern "C" int lud_internal_panel_launch(int device, int strategy, int ahead, int depth,
                                         const void* l, int lpitch, const void* u, int upitch,
                                         void* c, int cpitch, int h, int w, int k, int smem,
                                         int* launched, void* stream) {
  if (h < 1 || w < 1 || k != rt::kPanel || w % 4 || (lpitch | upitch | cpitch) % 4 ||
      !rt::aligned16(l) || !rt::aligned16(u) || !rt::aligned16(c) || lpitch < k ||
      upitch < w || cpitch < w || smem < 1)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::dispatch(strategy, ahead, 0,
                      rt::LudPanelLaunch{static_cast<const float*>(l),
                                         static_cast<const float*>(u), static_cast<float*>(c),
                                         lpitch, upitch, cpitch, h, w, k, depth, smem,
                                         launched, static_cast<cudaStream_t>(stream)});
}

// The whole factorisation of the contiguous (n, n) matrix a, in place: the
// panel schedule at the top of this file, lud_launches(n, bs) launches in
// kernels/lud.py.  n % bs == 0 and bs in {16, 32, 64} keep every block row
// and column start on 16 bytes.  smem is the K = bs body's; the panel body
// takes what its strategy and depth need.
extern "C" int lud_launch(int device, int strategy, int ahead, int out_depth, int depth,
                          void* a, int n, int bs, int smem, int* launched, void* stream) {
  if (!rt::card_bs(bs) || n < bs || n % bs || !rt::aligned16(a))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = rt::use_device(device, &sms);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(a);
  const long long N = n;
  auto at = [&](long long r, long long col) { return m + r * N + col; };
  // A[r0:r0+h, c0:c0+w] -= A[r0:r0+h, k0:k0+bs] A[k0:k0+bs, c0:c0+w]
  auto region = [&](long long r0, long long c0, long long k0, int h, int w) {
    return rt::LudRegion{at(r0, k0), at(k0, c0), at(r0, c0), N, N, N, h, w, 0};
  };
  for (int p = 0; p < n; p += rt::kPanel) {
    const int end = std::min(p + rt::kPanel, n);     // the panel is columns p..end
    for (int c = p; c < end; c += bs) {
      const int c1 = c + bs;
      float* dg = at(c, c);
      if ((e = rt::diagonal(bs, dg, N, launched, s)) != cudaSuccess) return e;
      if (c1 == n) break;
      e = rt::perimeters(bs, dg, N, at(c, c1), N, n - c1, at(c1, c), N, n - c1, launched, s);
      if (e != cudaSuccess) return e;
      if (c1 < end) {   // both updates: the panel's columns, its rows right of it
        e = rt::dispatch(strategy, ahead, out_depth,
                         rt::LudInternalLaunch{region(c1, c1, c, n - c1, end - c1),
                                               region(c1, end, c, end - c1, n - end), bs,
                                               depth, smem, sms, launched, s});
        if (e != cudaSuccess) return e;
      }
    }
    if (end < n) {
      e = rt::dispatch(strategy, ahead, 0,
                       rt::LudPanelLaunch{at(end, p), at(p, end), at(end, end), N, N, N,
                                          n - end, n - end, end - p, depth, 0, launched, s});
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}
