// Rodinia LUD for Hopper: blocked LU factorisation without pivoting, f32,
// in place on one (n, n) row-major matrix.  Step k of nb = n / bs:
//
//   lud_diagonal       A_kk = L_kk U_kk           (Doolittle, unit L)
//   lud_perimeter_row  U_kj = L_kk^-1 A_kj        (the block row right of A_kk)
//   lud_perimeter_col  L_ik = A_ik U_kk^-1        (the block column below A_kk)
//   lud_internal       A_ij -= L_ik U_kj          (the trailing matrix)
//
// Replaces src/repro/kernels/lud.py: lud_diagonal (line 43), lud_perimeter_row
// (line 65), lud_perimeter_col (line 96), lud_internal (line 152); the host
// loop lud_pallas (line 188), which runs under jax.jit as one program, is
// lud_launch below: one C call enqueues all 4 nb - 3 launches on the stream.
//
// In place: the four kernels of a step touch disjoint parts of the matrix
// (diagonal block; block row; block column; trailing matrix), each kernel
// reads only what an earlier launch of the stream wrote, and lud_internal
// reads every C tile before it writes that same tile back.  So one working
// copy of the input suffices and no kernel of a step reads what another
// kernel of the same step writes.
#include <algorithm>

#include "async_pipeline.cuh"

namespace rt {

constexpr int kDiagThreads = 256;
constexpr int kPerimThreads = 64;

// Slots of the int[4] launch counts every launcher fills in.
enum LudKernel { kDiagonal, kPerimeterRow, kPerimeterCol, kInternal };

// The error of the <<<>>> just before it; a launch that was enqueued adds
// one to `launched`.
inline cudaError_t counted(int* launched) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// ------------------------------------------------------------ diagonal --
// Replaces lud_diagonal / _diag_kernel (lud.py:30-49).
// Bound: latency.  One (bs, bs) block, 2 bs^2 * 4 bytes and (2/3) bs^3
// flops, is far below either roofline; what costs is the chain of bs - 1
// dependent elimination steps.  Design: one block holds the tile in shared
// memory (row pitch bs + 1 against bank conflicts) and runs the steps with
// a barrier after the column scale and one after the rank-1 update; the
// whole tile never leaves the SM between steps.
template <int BS>
__global__ void __launch_bounds__(kDiagThreads)
lud_diagonal_kernel(float* d, long long pitch) {
  __shared__ float t[BS][BS + 1];
  for (int e = threadIdx.x; e < BS * BS; e += kDiagThreads)
    t[e / BS][e % BS] = d[(e / BS) * pitch + e % BS];
  __syncthreads();
  for (int k = 0; k < BS - 1; ++k) {
    const float pivot = t[k][k];
    for (int i = k + 1 + threadIdx.x; i < BS; i += kDiagThreads) t[i][k] /= pivot;
    __syncthreads();
    const int m = BS - 1 - k;
    for (int e = threadIdx.x; e < m * m; e += kDiagThreads) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      t[i][j] -= t[i][k] * t[k][j];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < BS * BS; e += kDiagThreads)
    d[(e / BS) * pitch + e % BS] = t[e / BS][e % BS];
}

// ------------------------------------------------------ perimeter row --
// Replaces lud_perimeter_row / _perim_row_kernel (lud.py:54-78).
// Bound: HBM bytes.  The (bs, W) strip is read and written once, 8 bs W
// bytes against bs^2 W flops; at bs = 32 that is 4 flops a byte, below the
// card's 20.  Design: a thread owns one column and runs the forward
// substitution down it in registers (bs floats), so the strip is read and
// written once, coalesced (neighbouring threads, neighbouring columns); the
// unit-lower diagonal block sits in shared memory, read by broadcast.
template <int BS>
__global__ void __launch_bounds__(kPerimThreads)
lud_perimeter_row_kernel(const float* d, long long dpitch, float* s, long long spitch,
                         int w) {
  __shared__ float lo[BS][BS];
  for (int e = threadIdx.x; e < BS * BS; e += kPerimThreads)
    lo[e / BS][e % BS] = d[(e / BS) * dpitch + e % BS];
  __syncthreads();
  const int j = blockIdx.x * kPerimThreads + threadIdx.x;
  if (j >= w) return;
  float x[BS];
#pragma unroll
  for (int r = 0; r < BS; ++r) x[r] = s[r * spitch + j];
#pragma unroll
  for (int r = 1; r < BS; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < r; ++c) acc += lo[r][c] * x[c];
    x[r] -= acc;
  }
#pragma unroll
  for (int r = 0; r < BS; ++r) s[r * spitch + j] = x[r];
}

// ------------------------------------------------------ perimeter col --
// Replaces lud_perimeter_col / _perim_col_kernel (lud.py:83-109).
// Bound: HBM bytes, as the row strip.  Design: a thread owns one row of the
// (H, bs) strip and solves it against the upper diagonal block in registers.
// A row is bs contiguous floats, so a block first stages its kPerimThreads
// rows through shared memory with coalesced loads (pitch bs + 1: a thread
// then reads its own row without bank conflicts) and writes them back the
// same way.
template <int BS>
__global__ void __launch_bounds__(kPerimThreads)
lud_perimeter_col_kernel(const float* d, long long dpitch, float* s, long long spitch,
                         int h) {
  __shared__ float up[BS][BS];
  __shared__ float xs[kPerimThreads][BS + 1];
  const int i0 = blockIdx.x * kPerimThreads;
  const int rows = min(kPerimThreads, h - i0);
  for (int e = threadIdx.x; e < BS * BS; e += kPerimThreads)
    up[e / BS][e % BS] = d[(e / BS) * dpitch + e % BS];
  for (int e = threadIdx.x; e < rows * BS; e += kPerimThreads)
    xs[e / BS][e % BS] = s[(i0 + e / BS) * spitch + e % BS];
  __syncthreads();
  if (threadIdx.x < rows) {
    float x[BS];
#pragma unroll
    for (int c = 0; c < BS; ++c) x[c] = xs[threadIdx.x][c];
#pragma unroll
    for (int c = 0; c < BS; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < c; ++j) acc += x[j] * up[j][c];
      x[c] = (x[c] - acc) / up[c][c];
    }
#pragma unroll
    for (int c = 0; c < BS; ++c) xs[threadIdx.x][c] = x[c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * BS; e += kPerimThreads)
    s[(i0 + e / BS) * spitch + e % BS] = xs[e / BS][e % BS];
}

// ----------------------------------------------------------- internal --
// Replaces lud_internal / _internal_kernel (lud.py:114-183).
// Bound: HBM bytes at the large steps: C is read and written once, 8 H W
// bytes, against 2 H W bs flops (at bs = 32, 8 flops a byte; the card's
// f32 balance is 20).  Trailing matrices under ~3,500^2 fit the 50 MB L2,
// and there the bound moves towards the f32 rate.  Design: C tiles stream
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

cudaError_t perimeter_row(int bs, const float* d, long long dpitch, float* strip,
                          long long spitch, int w, int* launched, cudaStream_t s) {
  const int blocks = (w + kPerimThreads - 1) / kPerimThreads;
  switch (bs) {
    case 16:
      lud_perimeter_row_kernel<16><<<blocks, kPerimThreads, 0, s>>>(d, dpitch, strip, spitch, w);
      break;
    case 32:
      lud_perimeter_row_kernel<32><<<blocks, kPerimThreads, 0, s>>>(d, dpitch, strip, spitch, w);
      break;
    case 64:
      lud_perimeter_row_kernel<64><<<blocks, kPerimThreads, 0, s>>>(d, dpitch, strip, spitch, w);
      break;
    default: return kNotBuilt;
  }
  return counted(launched + kPerimeterRow);
}

cudaError_t perimeter_col(int bs, const float* d, long long dpitch, float* strip,
                          long long spitch, int h, int* launched, cudaStream_t s) {
  const int blocks = (h + kPerimThreads - 1) / kPerimThreads;
  switch (bs) {
    case 16:
      lud_perimeter_col_kernel<16><<<blocks, kPerimThreads, 0, s>>>(d, dpitch, strip, spitch, h);
      break;
    case 32:
      lud_perimeter_col_kernel<32><<<blocks, kPerimThreads, 0, s>>>(d, dpitch, strip, spitch, h);
      break;
    case 64:
      lud_perimeter_col_kernel<64><<<blocks, kPerimThreads, 0, s>>>(d, dpitch, strip, spitch, h);
      break;
    default: return kNotBuilt;
  }
  return counted(launched + kPerimeterCol);
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
// launches it enqueued to launched[4] (diagonal, perimeter row, perimeter
// column, internal).

// d: the (bs, bs) block at pitch `pitch`.
extern "C" int lud_diagonal_launch(int device, int bs, void* d, int pitch, int* launched,
                                   void* stream) {
  if (!rt::card_bs(bs) || pitch < bs) return cudaErrorInvalidValue;
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
  return rt::perimeter_row(bs, static_cast<const float*>(d), dpitch,
                           static_cast<float*>(strip), spitch, w, launched,
                           static_cast<cudaStream_t>(stream));
}

// d: the factored (bs, bs) diagonal block; strip: (h, bs), solved in place.
extern "C" int lud_perimeter_col_launch(int device, int bs, const void* d, int dpitch,
                                        void* strip, int spitch, int h, int* launched,
                                        void* stream) {
  if (!rt::card_bs(bs) || dpitch < bs || spitch < bs || h < 1) return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return rt::perimeter_col(bs, static_cast<const float*>(d), dpitch,
                           static_cast<float*>(strip), spitch, h, launched,
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

// The whole factorisation of the contiguous (n, n) matrix a, in place: the
// host loop of lud_pallas, 4 n/bs - 3 launches.  n % bs == 0 and bs in
// {16, 32, 64} keep every block row and column start on 16 bytes.
extern "C" int lud_launch(int device, int strategy, int ahead, int out_depth, int depth,
                          void* a, int n, int bs, int smem, int* launched, void* stream) {
  if (!rt::card_bs(bs) || n < bs || n % bs || !rt::aligned16(a))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = rt::use_device(device, &sms);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(a);
  const long long p = n;
  const int nb = n / bs;
  for (int k = 0; k < nb; ++k) {
    const long long lo = static_cast<long long>(k) * bs, hi = lo + bs;
    const int w = n - static_cast<int>(hi);
    float* dg = m + lo * p + lo;
    if ((e = rt::diagonal(bs, dg, p, launched, s)) != cudaSuccess) return e;
    if (k == nb - 1) break;
    e = rt::perimeter_row(bs, dg, p, m + lo * p + hi, p, w, launched, s);
    if (e != cudaSuccess) return e;
    e = rt::perimeter_col(bs, dg, p, m + hi * p + lo, p, w, launched, s);
    if (e != cudaSuccess) return e;
    e = rt::dispatch(strategy, ahead, out_depth,
                     rt::LudInternalLaunch{m + hi * p + lo, m + lo * p + hi, m + hi * p + hi,
                                           p, p, p, w, w, bs, depth, smem, sms, launched, s});
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
