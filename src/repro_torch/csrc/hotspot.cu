// Rodinia hotspot for Hopper: one step of the 5-point thermal stencil,
//   out = t + cap * (power + (up + down - 2t) ry + (left + right - 2t) rx
//                    + (80 - t) rz),
// on an edge-replicated field, f32.
//
// Replaces src/repro/kernels/hotspot.py: hotspot_step_pallas (line 68) and
// its body _hotspot_kernel (line 22); the host loop hotspot_pallas (line 109)
// is repro_torch.kernels.hotspot.hotspot_cuda.
//
// Bound: HBM bytes.  The step reads temp and power once and writes out once,
// 3 * R * C * 4 bytes, at 10 flops per cell.  What the design does about
// it: the kernel reads the caller's temp itself, with no padded copy, and
// replicates the edges by selects; a block reads each temperature row of
// its band once.  What it reads beyond the bound: the 4 columns on each
// side of a column tile that a 16-byte copy brings with its one halo
// column (264 of 256), and the two rows above a band (2 of 256 at the
// h100 cell).  Both input streams of a tile land on one ring slot under
// the strategy, and the output drains through the bulk-store ring, so
// loads and stores of neighbouring tiles overlap.
//
// Layout: block (blockIdx.x, blockIdx.y) = (row band, column tile); the
// launcher's `grid` row bands times ceil(C / HOTSPOT_TILE_COLS) column
// tiles.  A tile is tile_rows output rows r0 .. r0 + tile_rows - 1 of
// HOTSPOT_TILE_COLS columns, one column a thread.  Its temp operand is
// rows r0 + 1 .. r0 + tile_rows, one row down: it brings the next tile's
// lower halo, and a row past R - 1 reads R - 1 again (ClampedRows).
// The two rows above, r0 - 1 and r0, are the last two of the tile before
// (its compute, or DROP_OFF's load, copies them into a double-buffered
// carry: buffer i % 2 holds tile i's); a band's first tile has them from
// the carry's first fill, rows max(r0 - 1, 0) and r0, which the block
// loads before its pipeline.  A temp row of the slot is the window of
// columns ws = c0 - kHsOff .. c0 + TILE_COLS + kHsOff - 1 cut to
// [0, round4(C)), from the slot row's start: column c sits at c - ws, and
// a thread's slot column is k = (c0 - ws) + threadIdx.x (kHsOff, or 0 at
// c0 = 0, where the window starts at column 0 and no column lies left of it).
// The left neighbour of column 0 and the right one of column C - 1 are
// the column itself (selects on the index), so no cell of a column below
// C reads the window's cut or the row's padding past C, which may hold
// anything (NaN).  Every global row pitch is a multiple of 16 bytes and
// at least round4(C) floats; the ragged last column tile copies and
// stores its own round4(tc) columns, the output's columns past C being
// padding the wrapper slices off.
//
// Shared memory: [ring][out ring][TMA: mbarriers] as run_pipeline lays it
// out, then, at the next 16 bytes, the carry: 2 buffers x 2 rows x kHsWin.
//
// Barriers per tile (see async_pipeline.cuh for the loop):
//   SYNC            ld.global/st.shared staging of both operands, B1,
//                   compute (reads carry i % 2, writes (i + 1) % 2), fence,
//                   B2, store
//   REGISTER_BYPASS cp.async both operands, wait_group 0, B1, compute,
//                   fence, B2, store
//   OVERLAP         issue i+A, wait_group A, B1, compute, fence, B2, store
//   DROP_OFF        wait_group A-1, B0 (the stencil reads its neighbours'
//                   copies, so this one barrier is needed), read the
//                   column and its neighbours into registers and write the
//                   next carry, issue i+A, compute into the out slot,
//                   fence, B2, store
//   TMA             thread 0 expect-tx of both operands' bytes + one bulk
//                   load per row of each, all wait slot parity
//                   (i/depth)&1, B1, compute, fence, B2, store
// B2 of tile i orders its carry writes before tile i + 1's reads, and its
// reads before tile i + 2's writes of the same buffer.
#include "async_pipeline.cuh"

namespace rt {

constexpr int HOTSPOT_TILE_COLS = 256;                       // a tile's columns
constexpr int kHsOff = 4;                                    // window columns each side
constexpr int kHsWin = HOTSPOT_TILE_COLS + 2 * kHsOff;       // floats a temp row in smem
constexpr int kHsDropOffRows = 8;                            // DROP_OFF: rows in registers
constexpr int kHsCarry = 2 * 2 * kHsWin * 4;                 // bytes of the carry
static_assert(HOTSPOT_TILE_COLS == kThreads, "a thread owns one column of a tile");

// An operand whose rows past the array's last row read the last row
// again: the temperature's row R of the last band's last tile.
struct ClampedRows : Operand {
  const char* glast;   // the array's last row, at the operand's columns
  __device__ __forceinline__ const char* row(const char* g, int r) const {
    const char* p = Operand::row(g, r);
    return p > glast ? glast : p;
  }
};

struct HotspotBody {
  static constexpr bool kCrossThreadReads = true;
  int rows, k, kl, kr;   // tile rows; this thread's slot column and its neighbours'
  int buf;               // the carry buffer this tile reads
  float* carry;
  float rx, ry, rz, cap;
  // DROP_OFF: the column's rows r0 - 1 .. r0 + rows and, by row, the
  // neighbours and power
  float v[kHsDropOffRows + 2], lf[kHsDropOffRows], rg[kHsDropOffRows],
      pw[kHsDropOffRows];

  __device__ __forceinline__ float cell(float c, float u, float d, float l, float r,
                                        float p) const {
    return c + cap * (p + (u + d - 2.0f * c) * ry + (l + r - 2.0f * c) * rx +
                      (80.0f - c) * rz);
  }
  // The next tile's carry: rows r0 + rows - 1 (this column) and r0 + rows
  // (this column, and the halo columns by the first and last thread: their
  // neighbours, column 0's itself); row is r0 + rows.
  __device__ __forceinline__ void carry_on(float above, float last, const float* row) {
    float* nxt = carry + (buf ^ 1) * 2 * kHsWin;
    nxt[k] = above;
    nxt[kHsWin + k] = last;
    if (threadIdx.x == 0) nxt[kHsWin + kl] = row[kl];
    if (threadIdx.x == kThreads - 1) nxt[kHsWin + kr] = row[kr];
    buf ^= 1;
  }
  // in slot: [temp rows r0+1 .. r0+rows: rows x kHsWin][power: rows x TILE_COLS]
  __device__ __forceinline__ void compute(const char* in, char* out) {
    const float* T = reinterpret_cast<const float*>(in);
    const float* P = T + rows * kHsWin + threadIdx.x;
    float* Y = reinterpret_cast<float*>(out) + threadIdx.x;
    const float* mid = carry + buf * 2 * kHsWin + kHsWin;
    float u = mid[k - kHsWin], c = mid[k];
    for (int r = 0; r < rows; ++r) {
      const float* dn = T + r * kHsWin;
      const float d = dn[k];
      Y[r * HOTSPOT_TILE_COLS] = cell(c, u, d, mid[kl], mid[kr], P[r * HOTSPOT_TILE_COLS]);
      u = c;
      c = d;
      mid = dn;
    }
    carry_on(u, c, mid);
  }
  __device__ __forceinline__ void load(const char* in) {
    const float* T = reinterpret_cast<const float*>(in);
    const float* P = T + rows * kHsWin + threadIdx.x;
    const float* mid = carry + buf * 2 * kHsWin + kHsWin;
    v[0] = mid[k - kHsWin];
    v[1] = mid[k];
    lf[0] = mid[kl];
    rg[0] = mid[kr];
#pragma unroll
    for (int r = 0; r < kHsDropOffRows; ++r) {
      if (r < rows) {
        const float* dn = T + r * kHsWin;
        v[r + 2] = dn[k];
        pw[r] = P[r * HOTSPOT_TILE_COLS];
        if (r + 1 < kHsDropOffRows && r + 1 < rows) {
          lf[r + 1] = dn[kl];
          rg[r + 1] = dn[kr];
        }
        if (r + 1 == rows) carry_on(v[r + 1], v[r + 2], dn);
      }
    }
  }
  __device__ __forceinline__ void store(char* out) {
    float* Y = reinterpret_cast<float*>(out) + threadIdx.x;
#pragma unroll
    for (int r = 0; r < kHsDropOffRows; ++r)
      if (r < rows) Y[r * HOTSPOT_TILE_COLS] = cell(v[r + 1], v[r], v[r + 2], lf[r], rg[r], pw[r]);
  }
};

// Shared-memory bytes of the layout above (the wrapper's _smem).
__host__ __device__ inline int hotspot_smem(int strategy, int depth, int out_depth,
                                            int tile_rows) {
  const int slot = tile_rows * (kHsWin + HOTSPOT_TILE_COLS) * 4;
  const int ring = (strategy == SYNC ? 1 : depth) * slot;
  const int bars = strategy == TMA ? 8 * depth : 0;
  return (ring + out_depth * tile_rows * HOTSPOT_TILE_COLS * 4 + bars + 15) / 16 * 16 +
         kHsCarry;
}

template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads)
hotspot_kernel(const float* temp, int tpitch, const float* power, int ppitch, float* y,
               int ypitch, int rows, int cols, int tile_rows, int n_tiles, int depth,
               float rx, float ry, float rz, float cap) {
  const int c0 = blockIdx.y * HOTSPOT_TILE_COLS;
  const int tc = min(HOTSPOT_TILE_COLS, cols - c0);
  const int w4 = (tc + 3) & ~3;                                 // power / out columns
  const int ws = max(c0 - kHsOff, 0);                           // temp window
  const int we = min(c0 + HOTSPOT_TILE_COLS + kHsOff, (cols + 3) & ~3);
  const int row0 = blockIdx.x * n_tiles * tile_rows;
  const long long tp = 4LL * tpitch, pp = 4LL * ppitch, yp = 4LL * ypitch;
  const char* tw = reinterpret_cast<const char*>(temp + ws);
  const char* pw = reinterpret_cast<const char*>(power) + 4LL * c0;
  const ClampedRows op[2] = {
      {{tw + (row0 + 1) * tp, tp, tile_rows * tp, tile_rows, 4 * (we - ws), 4 * kHsWin},
       tw + (rows - 1) * tp},
      {{pw + row0 * pp, pp, tile_rows * pp, tile_rows, 4 * w4, 4 * HOTSPOT_TILE_COLS},
       pw + (rows - 1) * pp}};
  const OutTile out{reinterpret_cast<const char*>(y) + row0 * yp + 4LL * c0, yp,
                    tile_rows * yp, tile_rows, 4 * w4, 4 * HOTSPOT_TILE_COLS};
  HotspotBody body;
  body.rows = tile_rows;
  body.k = c0 - ws + threadIdx.x;
  const int col = c0 + threadIdx.x;
  body.kl = col == 0 ? body.k : body.k - 1;
  body.kr = col == cols - 1 ? body.k : body.k + 1;
  body.buf = 0;
  body.carry = reinterpret_cast<float*>(
      smem + hotspot_smem(S, depth, O, tile_rows) - kHsCarry);
  body.rx = rx;
  body.ry = ry;
  body.rz = rz;
  body.cap = cap;
  // the first tile's carry: rows max(row0 - 1, 0) and row0, a 16-byte
  // chunk a thread; run_pipeline's barrier before the first compute (B1,
  // or B0 under DROP_OFF) orders these stores before the reads
  const int chunks = (we - ws) / 4;
  if (threadIdx.x < 2 * chunks) {
    const int r = threadIdx.x / chunks, q = threadIdx.x % chunks;
    const int g = r == 0 ? max(row0 - 1, 0) : row0;
    reinterpret_cast<uint4*>(body.carry + r * kHsWin)[q] =
        reinterpret_cast<const uint4*>(tw + g * tp)[q];
  }
  run_pipeline<S, A, O>(body, op, out, n_tiles, depth);
}

struct HotspotLaunch {
  const void *temp, *power;
  void* y;
  int tpitch, ppitch, ypitch, rows, cols, tile_rows, n_tiles, depth;
  float rx, ry, rz, cap;
  int smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    auto kernel = hotspot_kernel<S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(rows / (n_tiles * tile_rows),
                    (cols + HOTSPOT_TILE_COLS - 1) / HOTSPOT_TILE_COLS);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(temp), tpitch, static_cast<const float*>(power), ppitch,
        static_cast<float*>(y), ypitch, rows, cols, tile_rows, n_tiles, depth, rx, ry, rz,
        cap);
    return cudaGetLastError();
  }
};

}  // namespace rt

// temp, power, y: (rows, pitch) row-major f32, each pitch (in floats) a
// multiple of 4 and at least round4(cols), each base on 16 bytes; temp's
// and power's columns past cols are not read into a kept cell.  smem must
// be at least hotspot_smem's bytes for the spec (DROP_OFF: tile_rows <= 8).
// Returns a cudaError_t; launches on `stream` and does not synchronise.
extern "C" int hotspot_bands_launch(int device, int strategy, int ahead, int out_depth,
                                    int depth, const void* temp, int tpitch,
                                    const void* power, int ppitch, void* y, int ypitch,
                                    int rows, int cols, int tile_rows, int n_tiles,
                                    int tile_cols, float rx, float ry, float rz,
                                    float cap, int smem, void* stream) {
  const int w4 = (cols + 3) & ~3;
  if (tile_cols != rt::HOTSPOT_TILE_COLS || n_tiles < 1 || tile_rows < 1 || cols < 1 ||
      rows % (n_tiles * tile_rows) != 0 || (tpitch | ppitch | ypitch) % 4 != 0 ||
      tpitch < w4 || ppitch < w4 || ypitch < w4 || !rt::aligned16(temp) ||
      !rt::aligned16(power) || !rt::aligned16(y) ||
      (strategy == rt::DROP_OFF && tile_rows > rt::kHsDropOffRows) ||
      smem < rt::hotspot_smem(strategy, depth, out_depth, tile_rows))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::dispatch(strategy, ahead, out_depth,
                      rt::HotspotLaunch{temp, power, y, tpitch, ppitch, ypitch, rows,
                                        cols, tile_rows, n_tiles, depth, rx, ry, rz,
                                        cap, smem, static_cast<cudaStream_t>(stream)});
}
