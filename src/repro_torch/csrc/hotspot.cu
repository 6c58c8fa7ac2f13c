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
// 3 * R * C * 4 bytes, at 10 flops per cell.  The wrapper's edge pad is one
// more pass over temp (read R*C*4, write (R+2)*pitch*4), which this kernel
// does not remove.  What the design does about the bound: the halo rows are
// the only bytes read twice (2 of every tile_rows+2 rows); both input
// streams of a tile land on one ring slot under the strategy, and the
// output drains through the bulk-store ring, so loads and stores of
// neighbouring tiles overlap.
//
// Layout: block (blockIdx.x, blockIdx.y) = (row band, column tile); the
// launcher's `grid` row bands times ceil(C / HOTSPOT_TILE_COLS) column
// tiles.  A tile is tile_rows output rows of HOTSPOT_TILE_COLS columns
// (compile-time); its temp operand is the (tile_rows+2)-row halo box of the
// padded field, round4(tc+2) columns wide.  Every global row pitch is a
// multiple of 16 bytes: the wrapper pads temp into rows of round4(C+2)
// floats and power and out into rows of round4(C) floats, since C+2 = 8194
// floats (32,776 bytes) or C = 126 floats (504 bytes) is not.  The ragged
// last column tile copies and stores only its own round4(tc) columns; the
// columns past C are padding the wrapper slices off.
//
// Barriers per tile (see async_pipeline.cuh for the loop):
//   SYNC            ld.global/st.shared staging of both operands, B1,
//                   compute, fence, B2, store
//   REGISTER_BYPASS cp.async both operands, wait_group 0, B1, compute,
//                   fence, B2, store
//   OVERLAP         issue i+A, wait_group A, B1, compute, fence, B2, store
//   DROP_OFF        wait_group A-1, B0 (the stencil reads its neighbours'
//                   copies, so this one barrier is needed), read the six
//                   values of each cell into registers, issue i+A, compute
//                   into the out slot, fence, B2, store
//   TMA             thread 0 expect-tx of both operands' bytes + one bulk
//                   load per row of each, all wait slot parity
//                   (i/depth)&1, B1, compute, fence, B2, store
#include "async_pipeline.cuh"

namespace rt {

constexpr int HOTSPOT_TILE_COLS = 256;
constexpr int kHaloPitch = HOTSPOT_TILE_COLS + 4;   // floats per halo row in shared memory

struct HotspotBody {
  static constexpr bool kCrossThreadReads = true;
  static constexpr int kMaxCells = 8;   // DROP_OFF: cells held per thread
  int rows;
  float rx, ry, rz, cap;
  float t[kMaxCells], up[kMaxCells], dn[kMaxCells], lf[kMaxCells], rg[kMaxCells],
      pw[kMaxCells];

  __device__ __forceinline__ float cell(float c, float u, float d, float l, float r,
                                        float p) const {
    return c + cap * (p + (u + d - 2.0f * c) * ry + (l + r - 2.0f * c) * rx +
                      (80.0f - c) * rz);
  }
  // in slot: [halo tile: (rows+2) x kHaloPitch][power tile: rows x TILE_COLS]
  __device__ __forceinline__ void compute(const char* in, char* out) {
    const float* T = reinterpret_cast<const float*>(in);
    const float* P = T + (rows + 2) * kHaloPitch;
    float* Y = reinterpret_cast<float*>(out);
    for (int e = threadIdx.x; e < rows * HOTSPOT_TILE_COLS; e += kThreads) {
      const int r = e / HOTSPOT_TILE_COLS, c = e % HOTSPOT_TILE_COLS;
      const float* m = T + (r + 1) * kHaloPitch + c + 1;
      Y[e] = cell(m[0], m[-kHaloPitch], m[kHaloPitch], m[-1], m[1], P[e]);
    }
  }
  __device__ __forceinline__ void load(const char* in) {
    const float* T = reinterpret_cast<const float*>(in);
    const float* P = T + (rows + 2) * kHaloPitch;
#pragma unroll
    for (int k = 0; k < kMaxCells; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < rows * HOTSPOT_TILE_COLS) {
        const int r = e / HOTSPOT_TILE_COLS, c = e % HOTSPOT_TILE_COLS;
        const float* m = T + (r + 1) * kHaloPitch + c + 1;
        t[k] = m[0];
        up[k] = m[-kHaloPitch];
        dn[k] = m[kHaloPitch];
        lf[k] = m[-1];
        rg[k] = m[1];
        pw[k] = P[e];
      }
    }
  }
  __device__ __forceinline__ void store(char* out) {
    float* Y = reinterpret_cast<float*>(out);
#pragma unroll
    for (int k = 0; k < kMaxCells; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < rows * HOTSPOT_TILE_COLS) Y[e] = cell(t[k], up[k], dn[k], lf[k], rg[k], pw[k]);
    }
  }
};

template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads)
hotspot_kernel(const float* tpad, int tpitch, const float* power, int ppitch,
               float* y, int ypitch, int cols, int tile_rows, int n_tiles, int depth,
               float rx, float ry, float rz, float cap) {
  const int c0 = blockIdx.y * HOTSPOT_TILE_COLS;
  const int tc = min(HOTSPOT_TILE_COLS, cols - c0);
  const int w4 = (tc + 3) & ~3;          // power / out columns, 16-byte rounded
  const int h4 = (tc + 2 + 3) & ~3;      // halo columns, 16-byte rounded
  const long long row0 = static_cast<long long>(blockIdx.x) * n_tiles * tile_rows;
  const long long tp = 4LL * tpitch, pp = 4LL * ppitch, yp = 4LL * ypitch;
  const Operand op[2] = {
      {reinterpret_cast<const char*>(tpad) + row0 * tp + 4LL * c0, tp, tile_rows * tp,
       tile_rows + 2, 4 * h4, 4 * kHaloPitch},
      {reinterpret_cast<const char*>(power) + row0 * pp + 4LL * c0, pp, tile_rows * pp,
       tile_rows, 4 * w4, 4 * HOTSPOT_TILE_COLS}};
  const OutTile out{reinterpret_cast<const char*>(y) + row0 * yp + 4LL * c0, yp,
                    tile_rows * yp, tile_rows, 4 * w4, 4 * HOTSPOT_TILE_COLS};
  HotspotBody body;
  body.rows = tile_rows;
  body.rx = rx;
  body.ry = ry;
  body.rz = rz;
  body.cap = cap;
  run_pipeline<S, A, O>(body, op, out, n_tiles, depth);
}

struct HotspotLaunch {
  const void *tpad, *power;
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
        static_cast<const float*>(tpad), tpitch, static_cast<const float*>(power),
        ppitch, static_cast<float*>(y), ypitch, cols, tile_rows, n_tiles, depth, rx,
        ry, rz, cap);
    return cudaGetLastError();
  }
};

}  // namespace rt

// tpad: (rows+2, tpitch) padded temperature; power: (rows, ppitch); y:
// (rows, ypitch); pitches in floats, each a multiple of 4.  Returns a
// cudaError_t; launches on `stream` and does not synchronise.
extern "C" int hotspot_step_launch(int device, int strategy, int ahead, int out_depth,
                                   int depth, const void* tpad, int tpitch,
                                   const void* power, int ppitch, void* y, int ypitch,
                                   int rows, int cols, int tile_rows, int n_tiles,
                                   int tile_cols, float rx, float ry, float rz,
                                   float cap, int smem, void* stream) {
  if (tile_cols != rt::HOTSPOT_TILE_COLS || n_tiles < 1 || tile_rows < 1 ||
      rows % (n_tiles * tile_rows) != 0 || (tpitch | ppitch | ypitch) % 4 != 0 ||
      tpitch < ((cols + 2 + 3) & ~3) || ppitch < ((cols + 3) & ~3) ||
      ypitch < ((cols + 3) & ~3))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::dispatch(strategy, ahead, out_depth,
                      rt::HotspotLaunch{tpad, power, y, tpitch, ppitch, ypitch, rows,
                                        cols, tile_rows, n_tiles, depth, rx, ry, rz,
                                        cap, smem, static_cast<cudaStream_t>(stream)});
}
