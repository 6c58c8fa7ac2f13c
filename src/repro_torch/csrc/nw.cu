// Rodinia Needleman-Wunsch for Hopper: the (n+1) x (n+1) f32 DP table
//   m[i, j] = max(m[i-1, j-1] + s[i-1, j-1], m[i, j-1] - p, m[i-1, j] - p),
// with m[i, 0] = m[0, i] = -i p.
//
// Replaces src/repro/kernels/nw.py: nw_pallas (line 89), its body _nw_kernel
// (line 45) and its max-plus scan _cummax (line 33).  The reference is one
// program (grid=()) that carries the DP row across the whole width in VMEM;
// here the table is cut into blocks of NW_BLOCK_ROWS x NW_BLOCK_COLS cells
// and swept as a wavefront, the host loop of Rodinia's `needle`.
//
// Bound: HBM bytes, n^2 * 4 of scores read and (n+1)^2 * 4 of table written
// once, at 4 operations a cell.  This design does not reach it: block (I, J)
// needs the blocks above and to its left, so a launch runs one anti-diagonal
// of blocks, at most n / NW_BLOCK_COLS of them (32 at n = 8192, a quarter
// of the SMs), and its n / NW_BLOCK_ROWS + n / NW_BLOCK_COLS - 1 launches
// (159 at n = 8192) are a chain.  Each block's rows are a chain too: a row
// is one block-wide scan.  What the design does about the bound: the score
// rows stream through the strategy's ring and the table rows drain through
// the bulk-store ring, so a block's copies overlap its scans.
//
// A row of a block, as in the reference: c[j] = max(m[i-1, j-1] + s,
// m[i-1, j] - p) for the thread's one column j, then m[i, j] = max over
// k <= j of (c[k] - (j - k) p), seeded with the left block's m[i, J0-1]:
// with t = c + j p this is an inclusive max-scan (a warp shuffle scan, one
// barrier to share the eight warp maxima) less j p.  Lane 0 of warp w takes
// its next row's m[i-1, j-1] from the prefix it already holds (the left
// warps' maxima and the seed, less (32 w - 1) p); every value is an integer
// below 2^24, so the f32 table equals the oracle exactly.
//
// Layout: the table is (n+1) rows of `tpitch` floats, table column j at
// float 3 + j of its row, so that column 1 + J NW_BLOCK_COLS, where block
// column J starts, lies on 16 bytes, and so does column J NW_BLOCK_COLS of
// the scores (s[i-1, j-1] belongs to cell (i, j)): no pass shifts the
// scores.  The wrapper fills row 0; the blocks of column 0 write column 0.
// The last block column and row may be ragged; copies and stores cover
// round4 of the block's own columns, and the columns past n land in the
// row's padding.
//
// Barriers per tile (see async_pipeline.cuh for the loop):
//   SYNC            ld.global/st.shared staging, B1, tile_rows rows (one
//                   barrier each), fence, B2, store
//   REGISTER_BYPASS cp.async, wait_group 0, B1, rows, fence, B2, store
//   OVERLAP         issue i+A, wait_group A, B1, rows, fence, B2, store
//   DROP_OFF        wait_group A-1, B0 (a thread reads its column of every
//                   row, copied by other threads), read into registers,
//                   issue i+A, rows into the out slot, fence, B2, store
//   TMA             thread 0 expect-tx + one bulk load per row of i+A, all
//                   wait slot parity (i/depth)&1, B1, rows, fence, B2, store
#include "async_pipeline.cuh"

namespace rt {

constexpr int NW_BLOCK_COLS = kThreads;   // one column per thread
constexpr int NW_BLOCK_ROWS = 64;         // rows of a block, at most
constexpr int kNwMaxRows = 16;            // DROP_OFF: score rows held per thread
constexpr int kWarps = kThreads / 32;

// Shared memory: run_pipeline's [ring][out ring][TMA mbarriers], then at
// the next 16 bytes the block's left column (NW_BLOCK_ROWS floats) and two
// sets of warp maxima (2 kWarps floats).
__host__ __device__ constexpr int nw_extra_offset(int s, int out_depth, int depth,
                                                  int tile_rows) {
  return ((s == SYNC ? 1 : depth) * tile_rows * NW_BLOCK_COLS * 4 +
          out_depth * tile_rows * NW_BLOCK_COLS * 4 + (s == TMA ? 8 * depth : 0) + 15) &
         ~15;
}
constexpr int kNwExtra = (NW_BLOCK_ROWS + 2 * kWarps) * 4;

struct NwBody {
  static constexpr bool kCrossThreadReads = true;
  int rows;            // rows per tile
  int r;               // the block's next row, from 0
  float p, jp;         // the penalty, and j p for this thread's column
  float up, up_left;   // m[i-1, j] and m[i-1, j-1] for the next row i
  const float* left;   // shared: m[i, J0-1] of the block's rows
  float* wmax;         // shared: 2 x kWarps warp maxima
  float s[kNwMaxRows];

  // One row from this thread's score; returns m[i, j].
  __device__ __forceinline__ float row(float sc) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float v = fmaxf(up_left + sc, up - p) + jp;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float x = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v = fmaxf(v, x);
    }
    float* wm = wmax + (r & 1) * kWarps;
    if (lane == 31) wm[warp] = v;
    __syncthreads();
    const float seed = left[r];
    float pre = seed - p;
    for (int w = 0; w < warp; ++w) pre = fmaxf(pre, wm[w]);
    const float m = fmaxf(v, pre) - jp;
    const float from_left = __shfl_up_sync(0xffffffffu, m, 1);
    up_left = lane > 0 ? from_left : (warp == 0 ? seed : pre - (32 * warp - 1) * p);
    up = m;
    ++r;
    return m;
  }
  __device__ __forceinline__ void compute(const char* in, char* out) {
    const float* S = reinterpret_cast<const float*>(in);
    float* Y = reinterpret_cast<float*>(out);
    for (int k = 0; k < rows; ++k)
      Y[k * NW_BLOCK_COLS + threadIdx.x] = row(S[k * NW_BLOCK_COLS + threadIdx.x]);
  }
  __device__ __forceinline__ void load(const char* in) {
    const float* S = reinterpret_cast<const float*>(in);
#pragma unroll
    for (int k = 0; k < kNwMaxRows; ++k)
      if (k < rows) s[k] = S[k * NW_BLOCK_COLS + threadIdx.x];
  }
  __device__ __forceinline__ void store(char* out) {
    float* Y = reinterpret_cast<float*>(out);
#pragma unroll
    for (int k = 0; k < kNwMaxRows; ++k)
      if (k < rows) Y[k * NW_BLOCK_COLS + threadIdx.x] = row(s[k]);
  }
};

// One anti-diagonal d of blocks: block column J = max(0, d - (nbr - 1)) +
// blockIdx.x, block row d - J.  `table` points at table column 0 of row 0.
template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads)
nw_kernel(const float* scores, long long spitch, float* table, long long tpitch, int n,
          int block_rows, int nbr, int d, float p, int tile_rows, int depth) {
  const int bj = max(0, d - (nbr - 1)) + static_cast<int>(blockIdx.x);
  const int bi = d - bj;
  const int i0 = 1 + bi * block_rows;                  // the block's first row
  const int j0 = 1 + bj * NW_BLOCK_COLS;               // and column
  const int rows = min(block_rows, n + 1 - i0);
  const int width = min(NW_BLOCK_COLS, n + 1 - j0);
  const int w4 = (width + 3) & ~3;
  const int j = threadIdx.x;
  char* extra = smem + nw_extra_offset(S, O, depth, tile_rows);
  float* left = reinterpret_cast<float*>(extra);
  float* wmax = left + NW_BLOCK_ROWS;
  for (int k = j; k < rows; k += kThreads) {
    if (bj == 0) {
      left[k] = -p * (i0 + k);
      table[(i0 + k) * tpitch] = left[k];
    } else {
      left[k] = table[(i0 + k) * tpitch + j0 - 1];
    }
  }
  // every strategy has a barrier (B1, or B0) before the first row reads left
  const float* above = table + (i0 - 1) * tpitch + j0;
  NwBody body;
  body.rows = tile_rows;
  body.r = 0;
  body.p = p;
  body.jp = j * p;
  body.up = j < width ? above[j] : 0.0f;
  body.up_left = j < width ? above[j - 1] : 0.0f;
  body.left = left;
  body.wmax = wmax;
  const Operand op[1] = {{reinterpret_cast<const char*>(scores + (i0 - 1) * spitch + j0 - 1),
                          4 * spitch, 4 * tile_rows * spitch, tile_rows, 4 * w4,
                          4 * NW_BLOCK_COLS}};
  const OutTile out{reinterpret_cast<const char*>(table + i0 * tpitch + j0), 4 * tpitch,
                    4 * tile_rows * tpitch, tile_rows, 4 * w4, 4 * NW_BLOCK_COLS};
  run_pipeline<S, A, O>(body, op, out, rows / tile_rows, depth);
}

struct NwLaunch {
  const float* scores;
  float* table;
  long long spitch, tpitch;
  int n, block_rows, nbr, nbc, d, tile_rows, depth, smem;
  float p;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (smem < nw_extra_offset(S, O, depth, tile_rows) + kNwExtra) return kNotBuilt;
    auto kernel = nw_kernel<S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const int lo = d - (nbr - 1) > 0 ? d - (nbr - 1) : 0;
    const int hi = d < nbc - 1 ? d : nbc - 1;
    kernel<<<hi - lo + 1, kThreads, smem, stream>>>(scores, spitch, table, tpitch, n,
                                                    block_rows, nbr, d, p, tile_rows,
                                                    depth);
    return cudaGetLastError();
  }
};

}  // namespace rt

// The whole table: the host loop over the nbr + nbc - 1 anti-diagonals of
// blocks, one launch each, enqueued on `stream` without synchronising.
// scores: (n, spitch) f32; table: (n+1, tpitch) f32 whose float 3 + j holds
// column j, row 0 filled by the caller.  Pitches are multiples of 4 with
// spitch >= round4(n) and tpitch >= round4(n) + 4; both arrays start on 16
// bytes.  Adds the launches it enqueued to *launched; returns a cudaError_t.
extern "C" int nw_launch(int device, int strategy, int ahead, int out_depth, int depth,
                         const void* scores, int spitch, void* table, int tpitch, int n,
                         int penalty, int tile_rows, int smem, int* launched,
                         void* stream) {
  const int n4 = (n + 3) & ~3;
  if (n < 1 || tile_rows < 1 || tile_rows > rt::NW_BLOCK_ROWS || n % tile_rows ||
      (spitch | tpitch) % 4 || spitch < n4 || tpitch < n4 + 4 || !rt::aligned16(scores) ||
      !rt::aligned16(table) || (strategy == rt::DROP_OFF && tile_rows > rt::kNwMaxRows))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int block_rows = rt::NW_BLOCK_ROWS / tile_rows * tile_rows;
  const int nbr = (n + block_rows - 1) / block_rows;
  const int nbc = (n + rt::NW_BLOCK_COLS - 1) / rt::NW_BLOCK_COLS;
  for (int d = 0; d < nbr + nbc - 1; ++d) {
    e = rt::dispatch(strategy, ahead, out_depth,
                     rt::NwLaunch{static_cast<const float*>(scores),
                                  static_cast<float*>(table) + 3, spitch, tpitch, n,
                                  block_rows, nbr, nbc, d, tile_rows, depth, smem,
                                  static_cast<float>(penalty),
                                  static_cast<cudaStream_t>(stream)});
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  return cudaSuccess;
}
