// Rodinia pathfinder for Hopper: the int32 row DP
//   dst[j] = wall[r, j] + min(prev[j-1], prev[j], prev[j+1]),
// neighbours clamped at the array's edges, over rows 1 .. rows-1 with row 0
// as the first prev; the result is the last row.
//
// Replaces src/repro/kernels/pathfinder.py: pathfinder_pallas (line 57) and
// its body _pathfinder_kernel (line 29).  The reference is one program
// (grid=()) that carries the whole DP row in VMEM; one block of an H100 is
// one of 132 SMs, so here the row is cut into strips, Rodinia's pyramid
// (ghost-zone) design.
//
// Bound: HBM bytes.  The function reads the wall once, rows * cols * 4
// bytes, and writes one row; it does 3 integer operations per cell.  What
// the design costs against that bound: each strip re-reads PF_HALO halo
// columns on each side (2 * 64 / 256 = 50% more wall bytes), and the rows
// are cut into launches of at most PF_HALO rows, each a dependent launch
// whose ring fills anew.  What it does about the bound: every block streams
// its strip's wall rows through the strategy's ring, `tile_rows` rows a
// tile, while the DP state stays in shared memory.
//
// Layout: one launch per pyramid of h <= PF_HALO rows (a multiple of
// tile_rows; pathfinder_launch below is the host loop).  Block b owns
// columns [b W, (b+1) W), W = PF_STRIP, and loads the previous row over
// [b W - H, (b+1) W + H), H = PF_HALO, clamped at the array's edges.  Each
// DP row clamps its neighbours at the strip's edges, so after k rows the
// columns within k of an inner strip edge are wrong and the rest are
// right; after h <= H rows every owned column is right, and the block
// writes them to one of two ping-pong rows in global memory, which the next
// launch reads as its previous row.  W and H are multiples of 4, so every
// strip starts on 16 bytes; the last strip is ragged and its copies cover
// round4 of its own columns only.
//
// Threads: a row of the strip is cpr 16-byte chunks (4 columns each).  The
// copies give chunk c of a tile to thread c % kThreads (async_pipeline.cuh),
// and the thread that copied a chunk is the one that computes its four
// columns, so DROP_OFF reads its wall values from its own registers with no
// barrier after the wait (kCrossThreadReads false).  The DP state is two
// rows in shared memory (read one, write the other) and one barrier ends
// each DP row.
//
// Barriers per tile (see async_pipeline.cuh for the loop; O = 0, no out ring):
//   SYNC            ld.global/st.shared staging, B1, tile_rows DP rows (a
//                   barrier each), B2
//   REGISTER_BYPASS cp.async, wait_group 0, B1, DP rows, B2
//   OVERLAP         issue i+A, wait_group A, B1, DP rows, B2
//   DROP_OFF        wait_group A-1, read own chunks into registers, issue
//                   i+A, B1, DP rows from registers, B2
//   TMA             thread 0 expect-tx + one bulk load per row of i+A, all
//                   wait slot parity (i/depth)&1, B1, DP rows, B2
#include "async_pipeline.cuh"

namespace rt {

constexpr int PF_STRIP = 256;                      // W: columns a block owns
constexpr int PF_HALO = 64;                        // H: halo each side, rows a launch at most
constexpr int kPfCols = PF_STRIP + 2 * PF_HALO;    // the widest haloed strip
constexpr int kPfChunks = 8;                       // DROP_OFF: chunks held per thread

static_assert(PF_STRIP % 4 == 0 && PF_HALO % 4 == 0, "strips start on 16 bytes");

// Shared memory: run_pipeline's [ring][TMA mbarriers], then the two DP
// state rows at the next 16 bytes.
__host__ __device__ constexpr int pf_state_offset(int s, int depth, int tile_rows) {
  return ((s == SYNC ? 1 : depth) * tile_rows * kPfCols * 4 + (s == TMA ? 8 * depth : 0) +
          15) & ~15;
}

struct PathfinderBody {
  static constexpr bool kCrossThreadReads = false;
  int rows;          // DP rows per tile
  int cols;          // columns of this block's strip
  int cpr;           // 16-byte chunks per strip row
  int cur;           // the state row that holds the previous DP row
  int* state;        // shared: two rows of kPfCols
  int4 regs[kPfChunks];
  int row_of[kPfChunks];   // DROP_OFF: the tile row of each held chunk, or -1

  // The four columns of chunk q of the next DP row, from wall values w.
  __device__ __forceinline__ void step(int q, int4 w) {
    const int* p = state + cur * kPfCols;
    int* n = state + (cur ^ 1) * kPfCols;
    const int wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      const int lo = min(p[max(j - 1, 0)], p[min(j + 1, cols - 1)]);
      n[j] = wv[k] + min(p[j], lo);
    }
  }
  __device__ __forceinline__ void end_row() {
    __syncthreads();
    cur ^= 1;
  }
  // Row r's chunk of this thread, if it has one: c = r cpr + q with
  // c % kThreads == threadIdx.x (cpr <= kThreads, so at most one).
  __device__ __forceinline__ int chunk_of(int r) const {
    return (static_cast<int>(threadIdx.x) - r * cpr) & (kThreads - 1);
  }
  __device__ __forceinline__ void compute(const char* in, char*) {
    for (int r = 0; r < rows; ++r) {
      const int q = chunk_of(r);
      if (q < cpr)
        step(q, *reinterpret_cast<const int4*>(in + r * kPfCols * 4 + q * 16));
      end_row();
    }
  }
  __device__ __forceinline__ void load(const char* in) {
#pragma unroll
    for (int k = 0; k < kPfChunks; ++k) {
      const int c = threadIdx.x + k * kThreads;
      row_of[k] = c < rows * cpr ? c / cpr : -1;
      if (row_of[k] >= 0)
        regs[k] = *reinterpret_cast<const int4*>(in + row_of[k] * kPfCols * 4 +
                                                 (c - row_of[k] * cpr) * 16);
    }
  }
  __device__ __forceinline__ void store(char*) {
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int k = 0; k < kPfChunks; ++k)
        if (row_of[k] == r) step(threadIdx.x + k * kThreads - r * cpr, regs[k]);
      end_row();
    }
  }
};

// One pyramid: DP rows r0 .. r0 + n_tiles * tile_rows - 1 of the wall (row
// pitch `pitch` ints), from prev (cols ints) into next.
template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads)
pathfinder_kernel(const int* wall, long long pitch, const int* prev, int* next, int cols,
                  int r0, int tile_rows, int n_tiles, int depth) {
  const int own0 = blockIdx.x * PF_STRIP;
  const int g0 = max(own0 - PF_HALO, 0);
  const int g1 = min(own0 + PF_STRIP + PF_HALO, cols);
  const int w4 = (g1 - g0 + 3) & ~3;
  int* state = reinterpret_cast<int*>(smem + pf_state_offset(S, depth, tile_rows));
  for (int j = threadIdx.x; j < g1 - g0; j += kThreads) state[j] = prev[g0 + j];
  // every strategy has a barrier (B1) before the first DP row reads state
  const Operand op[1] = {{reinterpret_cast<const char*>(wall + r0 * pitch + g0), 4 * pitch,
                          4 * tile_rows * pitch, tile_rows, 4 * w4, 4 * kPfCols}};
  PathfinderBody body;
  body.rows = tile_rows;
  body.cols = g1 - g0;
  body.cpr = w4 / 4;
  body.cur = 0;
  body.state = state;
  run_pipeline<S, A, O>(body, op, op[0], n_tiles, depth);
  // the last DP row ended with a barrier
  const int* fin = state + body.cur * kPfCols;
  const int own1 = min(own0 + PF_STRIP, cols);
  for (int j = own0 + threadIdx.x; j < own1; j += kThreads) next[j] = fin[j - g0];
}

struct PathfinderLaunch {
  static constexpr bool kTileOutput = false;
  const int* wall;
  long long pitch;
  const int* prev;
  int* next;
  int cols, r0, tile_rows, n_tiles, depth, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (smem < pf_state_offset(S, depth, tile_rows) + 2 * kPfCols * 4) return kNotBuilt;
    auto kernel = pathfinder_kernel<S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<(cols + PF_STRIP - 1) / PF_STRIP, kThreads, smem, stream>>>(
        wall, pitch, prev, next, cols, r0, tile_rows, n_tiles, depth);
    return cudaGetLastError();
  }
};

}  // namespace rt

// The whole DP: the host loop over pyramids, one launch each, enqueued on
// `stream` without synchronising.  wall: (rows, pitch) int32, pitch a
// multiple of 4 >= cols, 16-byte aligned; rowbuf: two rows of bpitch ints,
// launch k writing row k % 2, so the result is row (launches - 1) % 2.
// Adds the launches it enqueued to *launched; returns a cudaError_t.
extern "C" int pathfinder_launch(int device, int strategy, int ahead, int depth,
                                 const void* wall, int pitch, int rows, int cols,
                                 int tile_rows, void* rowbuf, int bpitch, int smem,
                                 int* launched, void* stream) {
  if (tile_rows < 1 || tile_rows > rt::PF_HALO || rows < 1 || cols < 1 ||
      (rows - 1) % tile_rows || (pitch | bpitch) % 4 || pitch < cols || bpitch < cols ||
      !rt::aligned16(wall) || !rt::aligned16(rowbuf) ||
      (strategy == rt::DROP_OFF &&
       tile_rows * (rt::kPfCols / 4) > rt::kPfChunks * rt::kThreads))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int height = rt::PF_HALO / tile_rows * tile_rows;
  const int* w = static_cast<const int*>(wall);
  int* buf = static_cast<int*>(rowbuf);
  const int* prev = w;                                 // row 0 starts the DP
  for (int done = 0, k = 0; done < rows - 1; done += height, ++k) {
    const int h = rows - 1 - done < height ? rows - 1 - done : height;
    int* next = buf + static_cast<long long>(k % 2) * bpitch;
    e = rt::dispatch(strategy, ahead, 0,
                     rt::PathfinderLaunch{w, pitch, prev, next, cols, 1 + done, tile_rows,
                                          h / tile_rows, depth, smem,
                                          static_cast<cudaStream_t>(stream)});
    if (e != cudaSuccess) return e;
    ++*launched;
    prev = next;
  }
  return cudaSuccess;
}
