// Rodinia LUD for Hopper: blocked LU factorisation without pivoting, f32,
// in place on one (n, n) row-major matrix.  The kernels:
//
//   lud_diagonal       A_kk = L_kk U_kk           (Doolittle, unit L)
//   lud_perimeters     U_kj = L_kk^-1 A_kj        (the block row right of A_kk)
//                      L_ik = A_ik U_kk^-1        (the block column below A_kk)
//                      in one launch, or either alone
//   lud_internal       A_ij -= L_ik U_kj          (K = bs: inside a panel)
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
//   3. lud_internal (K = bs) on rows c+bs..n, the panel's columns c+bs..p+b;
//   4. lud_internal (K = bs) on the panel's rows c+bs..p+b, columns p+b..n;
//
// then lud_internal_panel (K = b) on A[p+b:, p+b:] with L = A[p+b:, p:p+b]
// and U = A[p:p+b, p+b:].  Only a panel with columns right of it has a
// trailing update, so that update always runs at K = kPanel.  The same LU
// as the reference's loop; only the order of the rounding differs.
//
// In place: each launch reads only what earlier launches of the stream
// wrote, and writes a region that no other launch of its sub-step reads or
// writes (2's two strips are disjoint and it reads only the diagonal
// block; 3 and 4 write disjoint column ranges; neither writes the L or U
// it reads).  The K = bs body reads each C tile before it writes it.  The
// panel body never reads C on the SM: it adds -L U to it, one block a
// tile, and its C (the trailing matrix) is disjoint from its L and U.
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
// updates inside a panel (sub-steps 4 and 5 above).
// Bound: HBM bytes: C is read and written once, 8 H W bytes, against
// 2 H W bs flops (at bs = 32, 8 flops a byte; the card's f32 balance is
// 20).  In the panel schedule one of H and W is at most kPanel - bs.
// Design: C tiles stream
// through run_pipeline under the strategy, U tiles beside them in the same
// ring slot, and the updated tile drains through the bulk-store ring, so
// loads, update and stores of neighbouring tiles overlap.
//
// Tiles: LUD_BI x LUD_BJ = 64 x 64 floats, not the reference's 128 x 128.
// At 128 x 128 one ring slot (U 32 x 128 + C 128 x 128) is 80 KB, an output
// tile 64 KB and L 16 KB: depth 2 with out_depth 2 is 304 KB, over the
// 227 KB (232,448 bytes) a block may have.  At 64 x 64 and bs = 32 a slot is
// 8 + 16 = 24 KB, an output tile 16 KB and L 8 KB, so depth 4 with out_depth
// 4 is 96 + 64 + 8 = 168 KB; at bs = 64 it is 128 + 64 + 16 = 208 KB.
//
// Layout: block (blockIdx.x, blockIdx.y) = (row band of LUD_BI rows, group
// of `tiles` consecutive full column tiles), streamed through the ring;
// the launcher picks `tiles` so the grid keeps about two blocks per SM of
// the card (its SM count, read once per C call) while it can, and at most
// kMaxTiles per block.  A ragged last column tile (W % 64 columns, a
// multiple of 4) is one more block on blockIdx.y; a ragged last row band
// has fewer rows.  Copies and stores cover only the tile's own rows and
// columns.
//
// TMA: U and C arrive as one box each from two tensor maps (SWIZZLE_NONE,
// so the slot's rows stay at the dense 256-byte pitch the body reads), U's
// 64 x bs box over the (bs, W) panel and C's 64 x 64 box over the (H, W)
// trailing matrix, encoded on the host for each launch; the write-back is
// C's box too, one tensor store a tile.  A box past the ragged edge lands
// zeros in the slot (whose C tile is then always 64 rows), and the store
// is clipped to the matrix, so it writes only the tile's own rows and
// columns.  Row copies would cost the SM's TMA unit one request a row, 96
// loads and 64 stores a tile at bs = 32, with the stores queued ahead of
// the next tile's loads.
//
// Shared memory: run_pipeline's [ring][out ring][TMA mbarriers], then, at
// the next 16-byte boundary of the full-size layout, L_ik's rows of this
// band, transposed (lt[k * 64 + i]), loaded once per block before the
// loop.  Every strategy has a barrier (B1, or B0 for DROP_OFF) before its
// first compute, which orders those stores before the reads.
//
// Threads: thread t owns column t % 64 and rows 16 (t / 64) .. +16 of a
// tile.  Per k it reads one U value (32 lanes, 32 banks) and four float4 of
// L (one address per warp, a broadcast), and does 16 FMAs.  DROP_OFF holds
// the bs U values and 16 C values in registers (80 floats at bs = 64);
// its reads cross threads' copies, so kCrossThreadReads.
constexpr int LUD_BI = 64;
constexpr int LUD_BJ = 64;
constexpr int kLudRows = LUD_BI * LUD_BJ / kThreads;   // 16 rows per thread
constexpr int kLudMaxBs = 64;
constexpr int kMaxTiles = 8;

static_assert(kLudRows == 16 && LUD_BJ * 4 == kThreads, "thread layout");

__host__ __device__ constexpr int lud_lt_offset(int s, int out_depth, int depth, int bs) {
  return (((s == SYNC ? 1 : depth) * (bs + LUD_BI) * LUD_BJ * 4 +
           out_depth * LUD_BI * LUD_BJ * 4 + (s == TMA ? 8 * depth : 0)) + 15) & ~15;
}

struct LudBody {
  static constexpr bool kCrossThreadReads = true;
  int bs, rows, col, r0;
  const float* lt;
  float u[kLudMaxBs], c[kLudRows];

  __device__ __forceinline__ void fma_row(float (&acc)[kLudRows], int k, float uk) const {
    const float4* l = reinterpret_cast<const float4*>(lt + k * LUD_BI + r0);
#pragma unroll
    for (int q = 0; q < kLudRows / 4; ++q) {
      const float4 v = l[q];
      acc[4 * q] += v.x * uk;
      acc[4 * q + 1] += v.y * uk;
      acc[4 * q + 2] += v.z * uk;
      acc[4 * q + 3] += v.w * uk;
    }
  }
  // in slot: [U tile: bs x LUD_BJ][C tile: rows x LUD_BJ]
  __device__ __forceinline__ void compute(const char* in, char* out) {
    const float* U = reinterpret_cast<const float*>(in);
    const float* C = U + bs * LUD_BJ;
    float* Y = reinterpret_cast<float*>(out);
    float acc[kLudRows] = {};
    for (int k = 0; k < bs; ++k) fma_row(acc, k, U[k * LUD_BJ + col]);
#pragma unroll
    for (int r = 0; r < kLudRows; ++r) {
      const int e = (r0 + r) * LUD_BJ + col;
      if (r0 + r < rows) Y[e] = C[e] - acc[r];
    }
  }
  __device__ __forceinline__ void load(const char* in) {
    const float* U = reinterpret_cast<const float*>(in);
    const float* C = U + bs * LUD_BJ;
#pragma unroll
    for (int k = 0; k < kLudMaxBs; ++k)
      if (k < bs) u[k] = U[k * LUD_BJ + col];
#pragma unroll
    for (int r = 0; r < kLudRows; ++r)
      if (r0 + r < rows) c[r] = C[(r0 + r) * LUD_BJ + col];
  }
  __device__ __forceinline__ void store(char* out) {
    float* Y = reinterpret_cast<float*>(out);
    float acc[kLudRows] = {};
#pragma unroll
    for (int k = 0; k < kLudMaxBs; ++k)
      if (k < bs) fma_row(acc, k, u[k]);
#pragma unroll
    for (int r = 0; r < kLudRows; ++r)
      if (r0 + r < rows) Y[(r0 + r) * LUD_BJ + col] = c[r] - acc[r];
  }
};

template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads)
lud_internal_kernel(const float* l, long long lpitch, const float* u, long long upitch,
                    float* c, long long cpitch, int h, int w, int bs, int tiles,
                    int depth, const __grid_constant__ CUtensorMap umap,
                    const __grid_constant__ CUtensorMap cmap) {
  const int nf = w / LUD_BJ;                   // full column tiles
  const int row0 = blockIdx.x * LUD_BI;
  const int rows = min(LUD_BI, h - row0);
  int j0 = blockIdx.y * tiles, n_tiles = min(tiles, nf - j0), width = LUD_BJ;
  if (j0 >= nf) {                              // the ragged last column tile
    j0 = nf;
    n_tiles = 1;
    width = w - nf * LUD_BJ;
  }
  const long long col0 = static_cast<long long>(j0) * LUD_BJ;
  float* lt = reinterpret_cast<float*>(smem + lud_lt_offset(S, O, depth, bs));
  for (int e = threadIdx.x; e < rows * bs; e += kThreads) {
    const int i = e / bs, k = e - i * bs;
    lt[k * LUD_BI + i] = l[(row0 + i) * lpitch + k];
  }
  OutTile out{reinterpret_cast<const char*>(c + row0 * cpitch + col0), 4 * cpitch,
              4 * LUD_BJ, rows, 4 * width, 4 * LUD_BJ};
  Operand op[2] = {{reinterpret_cast<const char*>(u + col0), 4 * upitch, 4 * LUD_BJ, bs,
                    4 * width, 4 * LUD_BJ},
                   out};
  if constexpr (S == TMA) {   // whole boxes: U at (col0 + 64 i, 0), C at (col0 + 64 i, row0)
    op[0].map = &umap;
    op[1].map = &cmap;
    op[0].x0 = op[1].x0 = static_cast<int>(col0);
    op[0].dx = op[1].dx = LUD_BJ;
    op[1].y0 = row0;
    op[0].row_bytes = op[1].row_bytes = 4 * LUD_BJ;
    op[1].rows = LUD_BI;
    out.map = &cmap;            // the store: C's box, clipped to the matrix
    out.x0 = op[1].x0;
    out.dx = LUD_BJ;
    out.y0 = row0;
    out.rows = LUD_BI;
  }
  LudBody body;
  body.bs = bs;
  body.rows = rows;
  body.col = threadIdx.x % LUD_BJ;
  body.r0 = (threadIdx.x / LUD_BJ) * kLudRows;
  body.lt = lt;
  run_pipeline<S, A, O>(body, op, out, n_tiles, depth);
}

struct LudInternalLaunch {
  const float *l, *u;
  float* c;
  long long lpitch, upitch, cpitch;
  int h, w, bs, depth, smem, sms;
  int* launched;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (smem < lud_lt_offset(S, O, depth, bs) + bs * LUD_BI * 4) return kNotBuilt;
    CUtensorMap umap{}, cmap{};
    cudaError_t e = cudaSuccess;
    if constexpr (S == TMA) {
      e = encode_tensor_map_2d(&umap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, u, w, bs, 4ull * upitch,
                               LUD_BJ, bs, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (e == cudaSuccess)
        e = encode_tensor_map_2d(&cmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, c, w, h,
                                 4ull * cpitch, LUD_BJ, LUD_BI, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (e != cudaSuccess) return e;
    }
    auto kernel = lud_internal_kernel<S, A, O>;
    if ((e = ensure_smem(kernel, smem)) != cudaSuccess) return e;
    const int bands = (h + LUD_BI - 1) / LUD_BI, nf = w / LUD_BJ;
    const int tiles = std::max(1, std::min(kMaxTiles, bands * nf / (2 * sms)));
    const dim3 grid(bands, (nf + tiles - 1) / tiles + (w % LUD_BJ ? 1 : 0));
    kernel<<<grid, kThreads, smem, stream>>>(l, lpitch, u, upitch, c, cpitch, h, w, bs,
                                             tiles, depth, umap, cmap);
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

// c (h, w) -= l (h, bs) @ u (bs, w), c updated in place.  u and c start on
// 16 bytes, their pitches and w are multiples of 4 floats (cp.async, the
// bulk copies and the tensor maps move 16-byte units); smem covers
// run_pipeline's layout plus L.  Under TMA it encodes U's and C's tensor
// maps first, as lud_launch does at every step.
extern "C" int lud_internal_launch(int device, int strategy, int ahead, int out_depth,
                                   int depth, const void* l, int lpitch, const void* u,
                                   int upitch, void* c, int cpitch, int h, int w, int bs,
                                   int smem, int* launched, void* stream) {
  if (!rt::card_bs(bs) || h < 1 || w < 1 || w % 4 || (upitch | cpitch) % 4 ||
      !rt::aligned16(u) || !rt::aligned16(c) || lpitch < bs || upitch < w || cpitch < w)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = rt::use_device(device, &sms);
  if (e != cudaSuccess) return e;
  return rt::dispatch(strategy, ahead, out_depth,
                      rt::LudInternalLaunch{static_cast<const float*>(l),
                                            static_cast<const float*>(u),
                                            static_cast<float*>(c), lpitch, upitch, cpitch,
                                            h, w, bs, depth, smem, sms, launched,
                                            static_cast<cudaStream_t>(stream)});
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
  auto internal = [&](long long r0, long long c0, long long k0, int h, int w) {
    // A[r0:r0+h, c0:c0+w] -= A[r0:r0+h, k0:k0+bs] A[k0:k0+bs, c0:c0+w]
    return rt::dispatch(strategy, ahead, out_depth,
                        rt::LudInternalLaunch{at(r0, k0), at(k0, c0), at(r0, c0), N, N, N, h,
                                              w, bs, depth, smem, sms, launched, s});
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
      if (c1 < end) {
        if ((e = internal(c1, c1, c, n - c1, end - c1)) != cudaSuccess) return e;
        if (end < n && (e = internal(c1, end, c, end - c1, n - end)) != cudaSuccess) return e;
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
