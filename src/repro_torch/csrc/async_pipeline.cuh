// The paper's five asynchronous-copy strategies as device code for Hopper (sm_90a).
//
// Replaces the Pallas emitters of src/repro/core/async_pipeline.py:
// emit_sync, emit_register_bypass, emit_overlap, emit_drop_off, emit_tma
// (lines 233-381) and WriteBack.push/drain (lines 413-443).  There the TPU
// DMA engine models these instructions; here they are the instructions.
//
// One block streams its band of n_tiles tiles through a shared-memory ring
// (the loop inside the block replaces the TPU's sequential grid).  A tile is
// one or more input operands, each a few rows of a row-major array; every
// operand row is a multiple of 16 bytes and 16-byte aligned, in global and
// in shared memory.  A = PipelineSpec.ahead is the issue-ahead distance.
//
//   SYNC            ld.global into registers, st.shared into the staging
//                   tile, barrier B1, compute from shared memory.
//   REGISTER_BYPASS cp.async (16 B) into the one landing slot, commit,
//                   wait_group 0, barrier B1, compute in place.
//   OVERLAP         ring of `depth` slots.  Issue tile i+A, commit,
//                   wait_group A, barrier B1 (the paper's block
//                   synchronisation point), compute.  A=0: issue tile i,
//                   then wait on it.
//   DROP_OFF        wait_group A-1 on tile i, read it into registers, issue
//                   tile i+A, then compute.  With kCrossThreadReads false
//                   (each thread reads only the chunks it copied itself)
//                   there is no barrier between the wait and the read; the
//                   first barrier B1 comes after the next copy is issued.
//                   With kCrossThreadReads true (a stencil reads its
//                   neighbours' copies) one barrier B0 follows the wait.
//   TMA             one thread sets the slot's mbarrier expect-tx to the
//                   bytes of every operand of tile i+A and issues the
//                   loads as 1-D cp.async.bulk copies, one per operand row,
//                   all completing on that one mbarrier (the grouped wait).
//                   A = depth-1, no wait group.  Every thread waits on the
//                   slot's phase parity (i / depth) & 1, then barrier B1.
//                   Per-row 1-D copies stand in for a 2-D tensor map: a
//                   column tile of a row-major array is one contiguous run
//                   per row, and 1-D bulk copies need no driver-API
//                   descriptor (no libcuda link, nothing to encode per call).
//
//   WriteBack (every strategy): compute into slot i % out_depth of the
//   output ring.  Before B1 (B0 for cross-thread DROP_OFF) thread 0 runs
//   cp.async.bulk.wait_group.read (out_depth-1), so the store of tile
//   i-out_depth has finished reading that slot.  After compute every thread
//   runs fence.proxy.async.shared::cta, then barrier B2, then thread 0
//   issues one cp.async.bulk shared->global store per row and commits the
//   group.  The drain is wait_group 0 after the loop.
//
// Slot reuse: tile i+A lands in the slot of tile i+A-depth, whose compute
// ended before B2 of an earlier iteration, because A <= depth-1.  B2 is the
// barrier that frees both the input slot and the output slot.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace rt {

constexpr int kThreads = 256;
constexpr cudaError_t kNotBuilt = cudaErrorInvalidValue;

enum StrategyCode : int {  // the order of repro_torch.core.ALL_STRATEGIES
  SYNC = 0, REGISTER_BYPASS = 1, OVERLAP = 2, DROP_OFF = 3, TMA = 4
};

extern __shared__ __align__(128) char smem[];

// One input operand of a tile: rows x row_bytes copied from global memory.
struct Operand {
  const char* g;       // this block's tile 0, row 0, first column
  long long gpitch;    // global row pitch, bytes
  long long tstride;   // global bytes from tile i to tile i+1
  int rows;            // rows per tile
  int row_bytes;       // bytes copied per row, a multiple of 16
  int spitch;          // shared-memory row pitch, a multiple of 16
  __device__ __forceinline__ int tile_bytes() const { return rows * spitch; }
  __device__ __forceinline__ int chunks() const { return rows * (row_bytes >> 4); }
};

using OutTile = Operand;   // the same geometry, written instead of read

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(s)), "l"(g) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_g2s(void* s, const void* g, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(s)), "l"(g), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bulk_s2g(void* g, const void* s, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(g), "r"(smem_u32(s)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ copies --
// Every thread copies the 16-byte chunks c = threadIdx.x + k * kThreads of
// each operand; the bodies read tiles in the same order, which is what lets
// stream's DROP_OFF skip the barrier after its wait.

template <int NOPS>
__device__ __forceinline__ void issue_cp_async(const Operand (&op)[NOPS], int i,
                                               char* slot) {
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const char* g = op[k].g + i * op[k].tstride;
    const int cpr = op[k].row_bytes >> 4;
    for (int c = threadIdx.x; c < op[k].chunks(); c += kThreads) {
      const int r = c / cpr, q = c - r * cpr;
      cp_async16(slot + r * op[k].spitch + q * 16, g + r * op[k].gpitch + q * 16);
    }
    slot += op[k].tile_bytes();
  }
}

template <int NOPS>
__device__ __forceinline__ void load_sync(const Operand (&op)[NOPS], int i,
                                          char* stage) {
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const char* g = op[k].g + i * op[k].tstride;
    const int cpr = op[k].row_bytes >> 4;
    for (int c = threadIdx.x; c < op[k].chunks(); c += kThreads) {
      const int r = c / cpr, q = c - r * cpr;
      const uint4 v = *reinterpret_cast<const uint4*>(g + r * op[k].gpitch + q * 16);
      *reinterpret_cast<uint4*>(stage + r * op[k].spitch + q * 16) = v;
    }
    stage += op[k].tile_bytes();
  }
}

// Called by one thread: the grouped expect-tx, then one bulk copy per row.
template <int NOPS>
__device__ __forceinline__ void issue_bulk(const Operand (&op)[NOPS], int i,
                                           char* slot, uint64_t* bar) {
  uint32_t bytes = 0;
#pragma unroll
  for (int k = 0; k < NOPS; ++k) bytes += op[k].rows * op[k].row_bytes;
  mbar_expect_tx(bar, bytes);
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const char* g = op[k].g + i * op[k].tstride;
    for (int r = 0; r < op[k].rows; ++r)
      bulk_g2s(slot + r * op[k].spitch, g + r * op[k].gpitch, op[k].row_bytes, bar);
    slot += op[k].tile_bytes();
  }
}

// Called by one thread: one bulk store per row of output tile i, one group.
__device__ __forceinline__ void issue_store(const OutTile& o, int i, const char* slot) {
  char* g = const_cast<char*>(o.g) + i * o.tstride;
  for (int r = 0; r < o.rows; ++r)
    bulk_s2g(g + r * o.gpitch, slot + r * o.spitch, o.row_bytes);
  bulk_commit();
}

// ---------------------------------------------------------- the loop --
// Body provides:
//   static constexpr bool kCrossThreadReads;
//   void compute(const char* in_slot, char* out_slot);  // from shared memory
//   void load(const char* in_slot);                     // DROP_OFF: into registers
//   void store(char* out_slot);                         // DROP_OFF: from registers
// Shared memory: [ring: depth slots, or SYNC's one staging slot]
//                [out ring: O tiles][TMA: depth mbarriers]

template <int S, int A, int O, int NOPS, class Body>
__device__ __forceinline__ void run_pipeline(Body& body, const Operand (&op)[NOPS],
                                             const OutTile& out, int n_tiles,
                                             int depth) {
  static_assert(O >= 1 && A >= 0, "bad pipeline shape");
  int slot_bytes = 0;
#pragma unroll
  for (int k = 0; k < NOPS; ++k) slot_bytes += op[k].tile_bytes();
  const int out_bytes = out.tile_bytes();
  char* ring = smem;
  char* outring = smem + (S == SYNC ? 1 : depth) * slot_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(outring + O * out_bytes);
  const bool leader = threadIdx.x == 0;

  if constexpr (S == TMA) {
    if (leader) {
      for (int s = 0; s < depth; ++s) mbar_init(bars + s, 1);
      fence_mbar_init();
    }
    __syncthreads();
    if (leader)
      for (int j = 0; j < A && j < n_tiles; ++j)
        issue_bulk(op, j, ring + j * slot_bytes, bars + j);
  }
  if constexpr (S == OVERLAP || S == DROP_OFF) {
    for (int j = 0; j < A; ++j) {      // warm-up; empty groups keep the count
      if (j < n_tiles) issue_cp_async(op, j, ring + j * slot_bytes);
      cp_commit();
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int s = (S == SYNC || S == REGISTER_BYPASS) ? 0 : i % depth;
    char* in = ring + s * slot_bytes;
    char* o = outring + (i % O) * out_bytes;
    const int nxt = i + A;
    char* in_next = ring + (nxt % depth) * slot_bytes;

    if constexpr (S == DROP_OFF) {
      if constexpr (A == 0) {
        issue_cp_async(op, i, in);
        cp_commit();
      }
      cp_wait<(A > 0 ? A - 1 : 0)>();
      if constexpr (Body::kCrossThreadReads) {
        if (leader) bulk_wait_read<O - 1>();
        __syncthreads();                                   // B0
      }
      body.load(in);
      if constexpr (A > 0) {
        if (nxt < n_tiles) issue_cp_async(op, nxt, in_next);
        cp_commit();
      }
      if constexpr (!Body::kCrossThreadReads) {
        if (leader) bulk_wait_read<O - 1>();
        __syncthreads();                                   // B1
      }
      body.store(o);
    } else {
      if constexpr (S == SYNC) {
        load_sync(op, i, in);
      } else if constexpr (S == REGISTER_BYPASS) {
        issue_cp_async(op, i, in);
        cp_commit();
        cp_wait<0>();
      } else if constexpr (S == OVERLAP) {
        if constexpr (A > 0) {
          if (nxt < n_tiles) issue_cp_async(op, nxt, in_next);
        } else {
          issue_cp_async(op, i, in);
        }
        cp_commit();
        cp_wait<A>();
      } else if constexpr (S == TMA) {
        if (leader && nxt < n_tiles)
          issue_bulk(op, nxt, in_next, bars + nxt % depth);
        mbar_wait(bars + s, (i / depth) & 1);
      }
      if (leader) bulk_wait_read<O - 1>();
      __syncthreads();                                     // B1
      body.compute(in, o);
    }
    fence_proxy_async();
    __syncthreads();                                       // B2
    if (leader) issue_store(out, i, o);
  }
  if (leader) bulk_wait_all();
}

// --------------------------------------------------------- dispatch --
// F::run<S, A, O>() for the (strategy, ahead, out_depth) that PipelineSpec
// can produce: SYNC and REGISTER_BYPASS at A=0, OVERLAP and DROP_OFF at
// A=0..3, TMA at A=1..3 (depth-1), out_depth 1..4.  Anything else is
// kNotBuilt.

template <int S, int A, class F>
cudaError_t with_out(int out_depth, const F& f) {
  switch (out_depth) {
    case 1: return f.template run<S, A, 1>();
    case 2: return f.template run<S, A, 2>();
    case 3: return f.template run<S, A, 3>();
    case 4: return f.template run<S, A, 4>();
  }
  return kNotBuilt;
}

template <int S, class F>
cudaError_t with_ahead(int ahead, int out_depth, const F& f) {
  if constexpr (S == SYNC || S == REGISTER_BYPASS) {
    if (ahead == 0) return with_out<S, 0>(out_depth, f);
  } else {
    switch (ahead) {
      case 0: if constexpr (S != TMA) return with_out<S, 0>(out_depth, f); break;
      case 1: return with_out<S, 1>(out_depth, f);
      case 2: return with_out<S, 2>(out_depth, f);
      case 3: return with_out<S, 3>(out_depth, f);
    }
  }
  return kNotBuilt;
}

template <class F>
cudaError_t dispatch(int strategy, int ahead, int out_depth, const F& f) {
  switch (strategy) {
    case SYNC: return with_ahead<SYNC>(ahead, out_depth, f);
    case REGISTER_BYPASS: return with_ahead<REGISTER_BYPASS>(ahead, out_depth, f);
    case OVERLAP: return with_ahead<OVERLAP>(ahead, out_depth, f);
    case DROP_OFF: return with_ahead<DROP_OFF>(ahead, out_depth, f);
    case TMA: return with_ahead<TMA>(ahead, out_depth, f);
  }
  return kNotBuilt;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <class K>
cudaError_t ensure_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace rt

// Each source builds into its own library, so each carries this once.
extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
