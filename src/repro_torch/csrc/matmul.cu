// Tiled matmul for Hopper: C (M, N) f32 = A (M, K) @ B (K, N), A and B both
// f32 or both bf16, the K loop streamed through the strategy's ring.
//
// Replaces src/repro/kernels/matmul.py: matmul_pallas (line 63) and its body
// _matmul_kernel (line 26).  As there, one block owns one MM_BM x MM_BN
// output tile (grid (M / 128, N / 128)), streams the A (128 x kc) and B
// (kc x 128) tiles of its K loop as two Operands, keeps the accumulator on
// chip and drains it to C once after the loop.  The reference's bk is its
// K granularity; on the card each bk is kc-row sub-tiles, so that a ring of
// depth 4 fits a block's shared memory (f32 at bk = 128 is 128 KB a slot).
//
// Bound: operations.  At the h100/matmul shape (8192, 1536, 8960) bf16 the
// product is 225.5 GFLOP against 346 MB of A, B and C: 0.228 ms at the
// 989 TFLOP/s bf16 tensor-core rate, 0.103 ms at the HBM rate; in f32 it is
// 3.37 ms at the 66.9 TFLOP/s FFMA rate.  What the design does about it:
// the re-reads of A (once per N tile) and B (once per M tile) are L2 hits
// while the ring keeps `ahead` sub-tiles in flight, and the inner loop is
// FFMA from float4 loads (f32; no TF32, which would break the reference's
// 1e-4) or warp-level tensor cores, mma.sync m16n8k16 with f32 accumulators
// (bf16; products of bf16 are exact in f32).  wgmma is later work.
//
// Shared memory: run_pipeline's [ring][TMA mbarriers] only (no out ring:
// the launcher declares kTileOutput = false).  A slot is A's tile, rows of
// kc elements, then B's, rows of 128; every row pitch is its bytes + 16, so
// the eight rows an ldmatrix or a warp's float4 loads touch fall in
// different banks.
//
// f32 threads: thread t owns rows ty + 16 i (i < 8, ty = t / 16) and columns
// 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3 (tx = t % 16): 64
// accumulators.  Per 4 k it loads 8 float4 of A (one per row, two distinct
// rows a warp) and 8 float4 of B, and does 256 FFMAs.
// bf16 threads: warp w owns rows 64 (w % 2) .. +64 and columns 32 (w / 2) ..
// +32, 4 x 4 m16n8 tiles, 64 accumulators a thread.  Per 16 k it loads A
// fragments with 4 ldmatrix.x4 and B fragments with 2 ldmatrix.x4.trans
// (B sits k-major in the slot), and issues 16 mma.sync.
//
// DROP_OFF reads other threads' copies (kCrossThreadReads, barrier B0) and
// holds a thread's whole share of a slot in registers, so its sub-tile is
// smaller: kc = 4 for f32 (32 A and 32 B floats), 32 for bf16 (48 fragment
// registers); the others take kc = 32 (f32) and 64 (bf16).
//
// Barriers per sub-tile (see async_pipeline.cuh for the loop; O = 0):
//   SYNC            ld.global/st.shared staging, B1, FMAs/MMAs, B2
//   REGISTER_BYPASS cp.async, wait_group 0, B1, FMAs/MMAs, B2
//   OVERLAP         issue i+A, wait_group A, B1, FMAs/MMAs, B2
//   DROP_OFF        wait_group A-1, B0, operands into registers, issue i+A,
//                   FMAs/MMAs from registers, B2
//   TMA             thread 0 expect-tx + one bulk load per row of i+A (128
//                   rows of A, kc of B), all wait slot parity (i/depth)&1,
//                   B1, FMAs/MMAs, B2
#include <cuda_bf16.h>

#include "async_pipeline.cuh"

namespace rt {

constexpr int MM_BM = 128;         // output tile rows (the reference's bm)
constexpr int MM_BN = 128;         // output tile columns (the reference's bn)
constexpr int kRowPad = 16;        // bytes added to every row pitch in the ring

// K rows of a ring slot, by input type and strategy.
template <class T, int S>
struct MmK;
template <int S>
struct MmK<float, S> { static constexpr int kc = S == DROP_OFF ? 4 : 32; };
template <int S>
struct MmK<__nv_bfloat16, S> { static constexpr int kc = S == DROP_OFF ? 32 : 64; };

__host__ __device__ constexpr int mm_a_pitch(int kc, int isz) { return kc * isz + kRowPad; }
__host__ __device__ constexpr int mm_b_pitch(int isz) { return MM_BN * isz + kRowPad; }

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ------------------------------------------------------------------ f32 --

template <int KC>
struct MatmulF32Body {
  static constexpr bool kCrossThreadReads = true;
  static constexpr int kA = mm_a_pitch(KC, 4) / 4;   // A row pitch, floats
  static constexpr int kB = mm_b_pitch(4) / 4;       // B row pitch, floats
  int ty, tx;
  float acc[8][8];
  float4 ra[8], rb[KC][2];       // DROP_OFF: this thread's A rows and B columns

  __device__ __forceinline__ void init() {
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  // acc += a[:, kk] (x) (b0, b1)
  __device__ __forceinline__ void rank1(const float4 (&a)[8], int kk, float4 b0,
                                        float4 b1) {
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
  __device__ __forceinline__ void load_a(const float* A, int k, float4 (&a)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kA + k);
  }
  __device__ __forceinline__ float4 b_at(const float* B, int k, int half) const {
    return *reinterpret_cast<const float4*>(B + k * kB + 64 * half + 4 * tx);
  }
  __device__ __forceinline__ void compute(const char* in, char*) {
    const float* A = reinterpret_cast<const float*>(in);
    const float* B = A + MM_BM * kA;
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 a[8];
      load_a(A, k, a);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rank1(a, kk, b_at(B, k + kk, 0), b_at(B, k + kk, 1));
    }
  }
  __device__ __forceinline__ void load(const char* in) {
    static_assert(KC == 4, "DROP_OFF holds one float4 of A per row");
    const float* A = reinterpret_cast<const float*>(in);
    const float* B = A + MM_BM * kA;
    load_a(A, 0, ra);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      rb[kk][0] = b_at(B, kk, 0);
      rb[kk][1] = b_at(B, kk, 1);
    }
  }
  __device__ __forceinline__ void store(char*) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) rank1(ra, kk, rb[kk][0], rb[kk][1]);
  }
  __device__ __forceinline__ void drain(float* c, long long ldc) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = c + (ty + 16 * i) * ldc + 4 * tx;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 64) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
};

// ----------------------------------------------------------------- bf16 --

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
// d += a b for one m16n8k16 tile: bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KC>
struct MatmulBf16Body {
  static constexpr bool kCrossThreadReads = true;
  static constexpr int kA = mm_a_pitch(KC, 2);   // A row pitch, bytes
  static constexpr int kB = mm_b_pitch(2);       // B row pitch, bytes
  static constexpr int kSteps = KC / 16;
  int wm, wn, lane;
  float acc[4][4][4];
  uint32_t fa[kSteps][4][4], fb[kSteps][4][2];   // DROP_OFF: the slot's fragments

  __device__ __forceinline__ void init() {
    const int w = threadIdx.x / 32;
    wm = w % 2;
    wn = w / 2;
    lane = threadIdx.x % 32;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  }
  // The A and B fragments of k16 step `s` of the slot at `in`.
  __device__ __forceinline__ void fragments(const char* in, int s, uint32_t (&a)[4][4],
                                            uint32_t (&b)[4][2]) const {
    const uint32_t base_a = smem_u32(in), base_b = base_a + MM_BM * kA;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = 64 * wm + 16 * mi + (lane & 15);
      ldmatrix_x4(a[mi], base_a + row * kA + (16 * s + 8 * (lane >> 4)) * 2);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      const int krow = 16 * s + (lane & 15);
      ldmatrix_x4_trans(r, base_b + krow * kB + (32 * wn + 16 * nj + 8 * (lane >> 4)) * 2);
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
  }
  __device__ __forceinline__ void mmas(const uint32_t (&a)[4][4], const uint32_t (&b)[4][2]) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
  __device__ __forceinline__ void compute(const char* in, char*) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t a[4][4], b[4][2];
      fragments(in, s, a, b);
      mmas(a, b);
    }
  }
  __device__ __forceinline__ void load(const char* in) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) fragments(in, s, fa[s], fb[s]);
  }
  __device__ __forceinline__ void store(char*) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) mmas(fa[s], fb[s]);
  }
  // Accumulator e of tile (mi, ni): row g (+8 for e >= 2), columns 2 q, 2 q + 1
  // (g = lane / 4, q = lane % 4), the mma.sync m16n8 layout.
  __device__ __forceinline__ void drain(float* c, long long ldc) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* p = c + (64 * wm + 16 * mi + g + 8 * h) * ldc + 32 * wn + 8 * ni + 2 * q;
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
  }
};

template <class T, int KC>
using MatmulBody = std::conditional_t<std::is_same_v<T, float>, MatmulF32Body<KC>,
                                      MatmulBf16Body<KC>>;

template <class T, int S, int A, int O>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* a, const T* b, float* c, int k, int n, int depth) {
  constexpr int kc = MmK<T, S>::kc;
  constexpr int isz = sizeof(T);
  const long long row0 = static_cast<long long>(blockIdx.x) * MM_BM;
  const long long col0 = static_cast<long long>(blockIdx.y) * MM_BN;
  const Operand op[2] = {
      {reinterpret_cast<const char*>(a + row0 * k), static_cast<long long>(k) * isz,
       kc * isz, MM_BM, kc * isz, mm_a_pitch(kc, isz)},
      {reinterpret_cast<const char*>(b + col0), static_cast<long long>(n) * isz,
       static_cast<long long>(kc) * n * isz, kc, MM_BN * isz, mm_b_pitch(isz)}};
  MatmulBody<T, kc> body;
  body.init();
  run_pipeline<S, A, O>(body, op, op[0], k / kc, depth);
  body.drain(c + row0 * n + col0, n);
}

template <class T>
struct MatmulLaunch {
  static constexpr bool kTileOutput = false;
  const void *a, *b;
  void* c;
  int m, k, n, depth, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    constexpr int kc = MmK<T, S>::kc;
    constexpr int isz = sizeof(T);
    const int slot = MM_BM * mm_a_pitch(kc, isz) + kc * mm_b_pitch(isz);
    if (k % kc || smem < (S == SYNC ? 1 : depth) * slot + (S == TMA ? 8 * depth : 0))
      return kNotBuilt;
    auto kernel = matmul_kernel<T, S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(m / MM_BM, n / MM_BN), kThreads, smem, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(c), k, n,
        depth);
    return cudaGetLastError();
  }
};

}  // namespace rt

// c (m, n) f32 = a (m, k) @ b (k, n), all contiguous and 16-byte aligned;
// dtype 0 = f32, 1 = bf16 (a and b alike); m and n multiples of 128, k of the
// strategy's sub-tile (the wrapper checks bk).  One launch on `stream`, no
// synchronisation; returns a cudaError_t.
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
                        rt::MatmulLaunch<float>{a, b, c, m, k, n, depth, smem, s});
  if (dtype == 1)
    return rt::dispatch(strategy, ahead, 0,
                        rt::MatmulLaunch<__nv_bfloat16>{a, b, c, m, k, n, depth, smem, s});
  return rt::kNotBuilt;
}
