// The bf16 tensor-core instructions that the matmul and flash attention
// kernels share: ldmatrix, the SWIZZLE_128B shared-memory descriptor, and
// wgmma.mma_async m64nNk16 (f32 accumulators, bf16 operands) with A from
// shared memory (wgmma_ss) or from registers (wgmma_rs), with its fence,
// commit and wait.  N is the instruction's width: 128 (matmul's tile, and
// flash's P V at D = 128) or 64 (flash's Q K^T over a 64-row KV slot, and
// its P V at D = 64); a thread holds N / 2 accumulators.  Accumulator 4 j
// + 2 h + e of a thread is row g + 8 h of its warp's 16 and column 8 j + 2
// q + e (g = lane / 4, q = lane % 4), the wgmma f32 layout.  wgmma and
// setmaxnreg exist only for sm_90a.
#pragma once

#include <cstdint>

namespace rt {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
// The same with each 8 x 8 matrix transposed: lane i gets rows 2 (i % 4)
// and 2 (i % 4) + 1 of column i / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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
// A warpgroup's registers a thread, set by every warp of the warpgroup
// together: dec gives registers back to the block's pool, inc takes them
// (and waits until the pool holds them).  R is a multiple of 8 in 24..256.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmmas that own them.
template <int R>
__device__ __forceinline__ void hold_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define RT_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RT_ACC32                                                                      \
  RT_ACC4(0), RT_ACC4(4), RT_ACC4(8), RT_ACC4(12), RT_ACC4(16), RT_ACC4(20), RT_ACC4(24), \
      RT_ACC4(28)
#define RT_ACC64                                                                      \
  RT_ACC32, RT_ACC4(32), RT_ACC4(36), RT_ACC4(40), RT_ACC4(44), RT_ACC4(48), RT_ACC4(52), \
      RT_ACC4(56), RT_ACC4(60)

// d (N / 2 f32 a thread) += A B for one m64nNk16 step, f32 accumulators,
// bf16 operands: A and B from shared-memory descriptors, A K-major, B
// MN-major (imm-trans-b TB = 1) or K-major (TB = 0).  scale-d is 1: d
// accumulates.
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_ss is written out for N = 64 and 128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n"
        "}\n"
        : RT_ACC64
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : RT_ACC32
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
}
// The same with A from registers: each warp's m16n8k16 A fragment of its
// 16 rows of the warpgroup's 64; B MN-major (imm-trans-b = 1).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs is written out for N = 64 and 128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : RT_ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : RT_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef RT_ACC64
#undef RT_ACC32
#undef RT_ACC4

}  // namespace rt
