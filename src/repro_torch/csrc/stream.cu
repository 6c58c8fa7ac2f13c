// Stream microbenchmark (paper section 4.1) for Hopper: f(x) = 0.5 x + 0.5,
// applied `iters` times to every element, f32 or bf16.
//
// Replaces src/repro/kernels/stream.py: stream_pallas (line 62) and its body
// _stream_kernel (line 34).
//
// Bound: HBM bytes.  The function reads each element once and writes it
// once, 2 * R * W * itemsize bytes; at iters=1 it does 2 flops per element,
// far below the card's flops-per-byte balance.  What the design does about
// it: every block keeps `ahead` tiles of loads and up to out_depth tiles of
// stores in flight through the strategy's ring and the bulk-store ring, so
// the memory system always has work queued; 2048 blocks at the h100/stream
// shape keep every SM busy.
//
// Layout: block (blockIdx.x, blockIdx.y) = (row band, column tile).  A row
// band is n_tiles tiles of tile_rows rows, streamed through the ring inside
// the block; a column tile is STREAM_TILE_COLS columns (compile-time, so the
// tile fits shared memory at any width: one 4096-wide f32 row of 8 rows is
// already 128 KB).  The last column tile may be narrower; its copies and
// stores cover only its own columns.  The width in bytes must be a multiple
// of 16 (the wrapper checks).
//
// Barriers per tile (see async_pipeline.cuh for the loop):
//   SYNC            ld.global/st.shared staging, B1, compute, fence, B2, store
//   REGISTER_BYPASS cp.async, wait_group 0, B1, compute, fence, B2, store
//   OVERLAP         issue i+A, wait_group A, B1, compute, fence, B2, store
//   DROP_OFF        wait_group A-1, read own chunks into registers, issue
//                   i+A, B1, compute into the out slot, fence, B2, store;
//                   no barrier before the read: every thread reads only the
//                   chunks it copied itself
//   TMA             thread 0 expect-tx + bulk loads of i+A, all wait slot
//                   parity (i/depth)&1, B1, compute, fence, B2, store
// bf16 rounds to bf16 after every iteration, as the JAX kernel does.
#include <cuda_bf16.h>

#include "async_pipeline.cuh"

namespace rt {

constexpr int STREAM_TILE_COLS = 256;

__device__ __forceinline__ float f_iter(float v, int iters) {
  for (int t = 0; t < iters; ++t) v = v * 0.5f + 0.5f;
  return v;
}

__device__ __forceinline__ uint4 apply(uint4 v, int iters, float) {
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x = f_iter(f.x, iters);
  f.y = f_iter(f.y, iters);
  f.z = f_iter(f.z, iters);
  f.w = f_iter(f.w, iters);
  return *reinterpret_cast<uint4*>(&f);
}

__device__ __forceinline__ uint4 apply(uint4 v, int iters, __nv_bfloat16) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    for (int t = 0; t < iters; ++t) {
      float2 f = __bfloat1622float2(h[k]);
      f.x = f.x * 0.5f + 0.5f;
      f.y = f.y * 0.5f + 0.5f;
      h[k] = __float22bfloat162_rn(f);
    }
  }
  return v;
}

template <typename T>
struct StreamBody {
  static constexpr bool kCrossThreadReads = false;
  static constexpr int kMaxChunks = 8;   // DROP_OFF: 16-byte chunks held per thread
  int iters, chunks, cpr, spitch;
  uint4 regs[kMaxChunks];

  __device__ __forceinline__ int offset(int c) const {
    const int r = c / cpr;
    return r * spitch + (c - r * cpr) * 16;
  }
  __device__ __forceinline__ void compute(const char* in, char* out) {
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const int off = offset(c);
      *reinterpret_cast<uint4*>(out + off) =
          apply(*reinterpret_cast<const uint4*>(in + off), iters, T());
    }
  }
  __device__ __forceinline__ void load(const char* in) {
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < chunks) regs[k] = *reinterpret_cast<const uint4*>(in + offset(c));
    }
  }
  __device__ __forceinline__ void store(char* out) {
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < chunks) *reinterpret_cast<uint4*>(out + offset(c)) = apply(regs[k], iters, T());
    }
  }
};

template <int S, int A, int O, typename T>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const T* x, T* y, int width, int tile_rows, int n_tiles, int depth,
              int iters) {
  const int c0 = blockIdx.y * STREAM_TILE_COLS;
  const int tc = min(STREAM_TILE_COLS, width - c0);
  const long long row0 = static_cast<long long>(blockIdx.x) * n_tiles * tile_rows;
  const long long pitch = static_cast<long long>(width) * sizeof(T);
  const long long start = row0 * pitch + c0 * static_cast<long long>(sizeof(T));
  const int row_bytes = tc * static_cast<int>(sizeof(T));
  const int spitch = STREAM_TILE_COLS * static_cast<int>(sizeof(T));
  const Operand op[1] = {{reinterpret_cast<const char*>(x) + start, pitch,
                          tile_rows * pitch, tile_rows, row_bytes, spitch}};
  const OutTile out{reinterpret_cast<const char*>(y) + start, pitch,
                    tile_rows * pitch, tile_rows, row_bytes, spitch};
  StreamBody<T> body;
  body.iters = iters;
  body.cpr = row_bytes >> 4;
  body.chunks = tile_rows * body.cpr;
  body.spitch = spitch;
  run_pipeline<S, A, O>(body, op, out, n_tiles, depth);
}

template <typename T>
struct StreamLaunch {
  const void* x;
  void* y;
  int rows, width, tile_rows, n_tiles, depth, iters, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    auto kernel = stream_kernel<S, A, O, T>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(rows / (n_tiles * tile_rows),
                    (width + STREAM_TILE_COLS - 1) / STREAM_TILE_COLS);
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                             static_cast<T*>(y), width, tile_rows,
                                             n_tiles, depth, iters);
    return cudaGetLastError();
  }
};

}  // namespace rt

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t; launches on
// `stream` and does not synchronise.
extern "C" int stream_launch(int device, int strategy, int ahead, int out_depth,
                             int depth, int dtype, const void* x, void* y, int rows,
                             int width, int tile_rows, int n_tiles, int iters,
                             int tile_cols, int smem, void* stream) {
  if (tile_cols != rt::STREAM_TILE_COLS || n_tiles < 1 || tile_rows < 1 ||
      rows % (n_tiles * tile_rows) != 0 || (width * (dtype ? 2 : 4)) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rt::dispatch(strategy, ahead, out_depth,
                        rt::StreamLaunch<float>{x, y, rows, width, tile_rows,
                                                n_tiles, depth, iters, smem, s});
  if (dtype == 1)
    return rt::dispatch(strategy, ahead, out_depth,
                        rt::StreamLaunch<__nv_bfloat16>{x, y, rows, width, tile_rows,
                                                        n_tiles, depth, iters, smem, s});
  return rt::kNotBuilt;
}
