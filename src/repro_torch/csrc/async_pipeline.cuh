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
//                   bytes of every operand of tile i+A and issues its
//                   loads, all completing on that one mbarrier (the
//                   grouped wait): an operand with a tensor map is one
//                   cp.async.bulk.tensor.2d of its whole box, one without
//                   is one 1-D cp.async.bulk per row.  A = depth-1, no
//                   wait group.  Every thread waits on the slot's phase
//                   parity (i / depth) & 1, then barrier B1.  A per-row
//                   loop costs the issuing thread one instruction and the
//                   TMA unit one request per row (192 a bf16 matmul slot,
//                   96 a lud_internal slot at bs = 32); a box is one of
//                   each.  The maps are encoded on the host
//                   (encode_tensor_map_2d: cuTensorMapEncodeTiled through
//                   cudaGetDriverEntryPoint, so no library links libcuda)
//                   and reach the kernel as __grid_constant__ parameters.
//                   A box that runs past the array is filled with zeros,
//                   and its bytes still count toward expect-tx.
//
//   Swizzled operands (Operand::swizzle128, rows of exactly 128 bytes):
//   the 16-byte chunk q of row r lands at r * 128 + ((q ^ (r & 7)) << 4)
//   of its tile, the layout wgmma reads as SWIZZLE_128B and TMA writes for
//   CU_TENSOR_MAP_SWIZZLE_128B.  Such a tile needs a 1024-byte-aligned
//   base: a Body that declares kRingAlign gets its ring base rounded up to
//   it (the launcher budgets the padding).  A Body that declares
//   kAsyncProxyReads (wgmma reads the slot through the async proxy) makes
//   every thread run fence.proxy.async.shared::cta after its own
//   st.shared / cp.async writes have landed and before the barrier that
//   precedes the reads (B1; B0 for DROP_OFF), or wgmma may read stale data.
//
//   WriteBack (every strategy with O = out_depth >= 1): compute into slot
//   i % out_depth of the output ring.  Before B1 (B0 for cross-thread
//   DROP_OFF) thread 0 runs cp.async.bulk.wait_group.read (out_depth-1),
//   so the store of tile
//   i-out_depth has finished reading that slot.  After compute every thread
//   runs fence.proxy.async.shared::cta, then barrier B2, then thread 0
//   issues the store and commits the group: one cp.async.bulk
//   shared->global store per row, or, for an OutTile with a tensor map (a
//   TMA kernel's), one cp.async.bulk.tensor.2d store of the whole box,
//   which the TMA unit clips at the array's edge.  The stores share the
//   SM's TMA unit with the loads, so a tile's 64 row stores would queue
//   ahead of the next box load.  The drain is wait_group 0 after the loop.
//
//   O = 0: a kernel with no per-tile output (its result leaves the block
//   after the loop).  There is no out ring, no wait_group.read, no fence
//   and no store; B2 still frees the input slot, and the body's compute
//   and store get a null out slot.  The code for O >= 1 is unchanged.
//
// Slot reuse: tile i+A lands in the slot of tile i+A-depth, whose compute
// ended before B2 of an earlier iteration, because A <= depth-1.  B2 is the
// barrier that frees both the input slot and the output slot.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums only: nothing links libcuda
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace rt {

constexpr int kThreads = 256;
constexpr cudaError_t kNotBuilt = cudaErrorInvalidValue;

enum StrategyCode : int {  // the order of repro_torch.core.ALL_STRATEGIES
  SYNC = 0, REGISTER_BYPASS = 1, OVERLAP = 2, DROP_OFF = 3, TMA = 4
};

extern __shared__ __align__(128) char smem[];

// One input operand of a tile: rows x row_bytes copied from global memory.
// Under TMA an operand with a tensor map is its box instead: rows x
// row_bytes, at box coordinates (x0 + i dx, y0 + i dy) for tile i (x the
// inner, contiguous dimension, in elements).
struct Operand {
  const char* g;       // this block's tile 0, row 0, first column
  long long gpitch;    // global row pitch, bytes
  long long tstride;   // global bytes from tile i to tile i+1
  int rows;            // rows per tile
  int row_bytes;       // bytes copied per row, a multiple of 16
  int spitch;          // shared-memory row pitch, a multiple of 16
  const CUtensorMap* map = nullptr;   // TMA: one 2-D box per tile
  int x0 = 0, y0 = 0, dx = 0, dy = 0;
  bool swizzle128 = false;            // 128-byte swizzled rows (see above)
  __device__ __forceinline__ int tile_bytes() const { return rows * spitch; }
  __device__ __forceinline__ int chunks() const { return rows * (row_bytes >> 4); }
  // where the 16-byte chunk q of row r lands in the tile at `tile`
  __device__ __forceinline__ char* at(char* tile, int r, int q) const {
    return swizzle128 ? tile + r * 128 + ((q ^ (r & 7)) << 4) : tile + r * spitch + q * 16;
  }
  // global row r of the tile whose row 0 is at g; an operand type derived
  // from this one may read another row there (the copies below take any)
  __device__ __forceinline__ const char* row(const char* g, int r) const {
    return g + r * gpitch;
  }
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

// One arrival on a barrier that counts arrivals and no bytes: a consumer
// that frees a ring slot (its producer waits on the slot's empty barrier).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// mbar_wait that gives up: after kMbarSpinNs of %globaltimer it runs
// __trap(), so a fault of a producer / consumer protocol fails the launch
// instead of hanging the card.  A fresh barrier passes a wait on parity 1
// at once (the phase before its first), which is how a producer waits on
// the empty barriers of a ring's first round.
constexpr unsigned kMbarSpinNs = 2000000000u;
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ unsigned globaltimer_ns() {
  unsigned t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned start = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - start > kMbarSpinNs) __trap();
}

__device__ __forceinline__ void bulk_g2s(void* s, const void* g, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(s)), "l"(g), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* s, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(s)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int x, int y,
                                             const void* s) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(s))
               : "memory");
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

template <int NOPS, class Op>
__device__ __forceinline__ void issue_cp_async(const Op (&op)[NOPS], int i, char* slot) {
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const char* g = op[k].g + i * op[k].tstride;
    const int cpr = op[k].row_bytes >> 4;
    for (int c = threadIdx.x; c < op[k].chunks(); c += kThreads) {
      const int r = c / cpr, q = c - r * cpr;
      cp_async16(op[k].at(slot, r, q), op[k].row(g, r) + q * 16);
    }
    slot += op[k].tile_bytes();
  }
}

// SYNC of a tile whose operands are all swizzled (whole 128-byte rows, at
// most 4 chunks an operand a thread): every load of the tile is in flight
// before the first st.shared.  In load_sync's loop a store may alias a
// later load as far as the compiler knows, so each load waits for the
// store before it.
constexpr int kSwizzledChunks = 4;

template <int NOPS, class Op>
__device__ __forceinline__ void load_sync_swizzled(const Op (&op)[NOPS], int i,
                                                   char* stage) {
  uint4 v[NOPS][kSwizzledChunks];
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const char* g = op[k].g + i * op[k].tstride;
#pragma unroll
    for (int j = 0; j < kSwizzledChunks; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < op[k].chunks())
        v[k][j] = *reinterpret_cast<const uint4*>(g + (c >> 3) * op[k].gpitch + (c & 7) * 16);
    }
  }
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
#pragma unroll
    for (int j = 0; j < kSwizzledChunks; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < op[k].chunks()) *reinterpret_cast<uint4*>(op[k].at(stage, c >> 3, c & 7)) = v[k][j];
    }
    stage += op[k].tile_bytes();
  }
}

template <int NOPS, class Op>
__device__ __forceinline__ void load_sync(const Op (&op)[NOPS], int i, char* stage) {
  if (op[0].swizzle128) {
    load_sync_swizzled(op, i, stage);
    return;
  }
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const char* g = op[k].g + i * op[k].tstride;
    const int cpr = op[k].row_bytes >> 4;
    for (int c = threadIdx.x; c < op[k].chunks(); c += kThreads) {
      const int r = c / cpr, q = c - r * cpr;
      const uint4 v = *reinterpret_cast<const uint4*>(op[k].row(g, r) + q * 16);
      *reinterpret_cast<uint4*>(op[k].at(stage, r, q)) = v;
    }
    stage += op[k].tile_bytes();
  }
}

// Called by one thread: the grouped expect-tx, then per operand one box
// from its tensor map or one bulk copy per row.
template <int NOPS, class Op>
__device__ __forceinline__ void issue_bulk(const Op (&op)[NOPS], int i, char* slot,
                                           uint64_t* bar) {
  uint32_t bytes = 0;
#pragma unroll
  for (int k = 0; k < NOPS; ++k) bytes += op[k].rows * op[k].row_bytes;
  mbar_expect_tx(bar, bytes);
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    if (op[k].map) {
      tma_load_2d(slot, op[k].map, op[k].x0 + i * op[k].dx, op[k].y0 + i * op[k].dy, bar);
    } else {
      const char* g = op[k].g + i * op[k].tstride;
      for (int r = 0; r < op[k].rows; ++r)
        bulk_g2s(slot + r * op[k].spitch, op[k].row(g, r), op[k].row_bytes, bar);
    }
    slot += op[k].tile_bytes();
  }
}

// Called by one thread: output tile i as one box to its tensor map (the
// TMA unit clips what lies past the array) or one bulk store per row; one
// group.
__device__ __forceinline__ void issue_store(const OutTile& o, int i, const char* slot) {
  if (o.map) {
    tma_store_2d(o.map, o.x0 + i * o.dx, o.y0 + i * o.dy, slot);
  } else {
    char* g = const_cast<char*>(o.g) + i * o.tstride;
    for (int r = 0; r < o.rows; ++r)
      bulk_s2g(g + r * o.gpitch, slot + r * o.spitch, o.row_bytes);
  }
  bulk_commit();
}

// ---------------------------------------------------------- the loop --
// Optional Body members: kRingAlign (bytes the ring base is rounded up
// to) and kAsyncProxyReads (the proxy fence before B1 / B0; see the top).

template <class B, class = void>
struct ring_align : std::integral_constant<int, 1> {};
template <class B>
struct ring_align<B, std::void_t<decltype(B::kRingAlign)>>
    : std::integral_constant<int, B::kRingAlign> {};
template <class B, class = void>
struct async_proxy_reads : std::false_type {};
template <class B>
struct async_proxy_reads<B, std::void_t<decltype(B::kAsyncProxyReads)>>
    : std::bool_constant<B::kAsyncProxyReads> {};

// Body provides:
//   static constexpr bool kCrossThreadReads;
//   void compute(const char* in_slot, char* out_slot);  // from shared memory
//   void load(const char* in_slot);                     // DROP_OFF: into registers
//   void store(char* out_slot);                         // DROP_OFF: from registers
// Shared memory: [padding to kRingAlign, if declared]
//                [ring: depth slots, or SYNC's one staging slot]
//                [out ring: O tiles][TMA: depth mbarriers]
// With O = 0, `out` is not read.

template <int S, int A, int O, int NOPS, class Body, class Op>
__device__ __forceinline__ void run_pipeline(Body& body, const Op (&op)[NOPS],
                                             const OutTile& out, int n_tiles,
                                             int depth) {
  static_assert(O >= 0 && A >= 0, "bad pipeline shape");
  int slot_bytes = 0;
#pragma unroll
  for (int k = 0; k < NOPS; ++k) slot_bytes += op[k].tile_bytes();
  const int out_bytes = out.tile_bytes();
  constexpr int kAlign = ring_align<Body>::value;
  constexpr bool kFence = async_proxy_reads<Body>::value;
  char* ring = smem;
  if constexpr (kAlign > 1) ring += (kAlign - smem_u32(smem) % kAlign) % kAlign;
  char* outring = ring + (S == SYNC ? 1 : depth) * slot_bytes;
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
    char* o = nullptr;
    if constexpr (O > 0) o = outring + (i % O) * out_bytes;
    const int nxt = i + A;
    char* in_next = ring + (nxt % depth) * slot_bytes;

    if constexpr (S == DROP_OFF) {
      if constexpr (A == 0) {
        issue_cp_async(op, i, in);
        cp_commit();
      }
      cp_wait<(A > 0 ? A - 1 : 0)>();
      if constexpr (kFence) fence_proxy_async();
      if constexpr (Body::kCrossThreadReads) {
        if constexpr (O > 0) {
          if (leader) bulk_wait_read<O - 1>();
        }
        __syncthreads();                                   // B0
      }
      body.load(in);
      if constexpr (A > 0) {
        if (nxt < n_tiles) issue_cp_async(op, nxt, in_next);
        cp_commit();
      }
      if constexpr (!Body::kCrossThreadReads) {
        if constexpr (O > 0) {
          if (leader) bulk_wait_read<O - 1>();
        }
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
      if constexpr (kFence && S != TMA) fence_proxy_async();
      if constexpr (O > 0) {
        if (leader) bulk_wait_read<O - 1>();
      }
      __syncthreads();                                     // B1
      body.compute(in, o);
    }
    if constexpr (O > 0) fence_proxy_async();
    __syncthreads();                                       // B2
    if constexpr (O > 0) {
      if (leader) issue_store(out, i, o);
    }
  }
  if constexpr (O > 0) {
    if (leader) bulk_wait_all();
  }
}

// --------------------------------------------------------- dispatch --
// F::run<S, A, O>() for the (strategy, ahead, out_depth) that PipelineSpec
// can produce: SYNC and REGISTER_BYPASS at A=0, OVERLAP and DROP_OFF at
// A=0..3, TMA at A=1..3 (depth-1), out_depth 1..4; or, for an F that
// declares `static constexpr bool kTileOutput = false`, out_depth 0 only.
// Anything else is kNotBuilt.

template <class F, class = void>
struct tile_output : std::true_type {};
template <class F>
struct tile_output<F, std::void_t<decltype(F::kTileOutput)>>
    : std::bool_constant<F::kTileOutput> {};

template <int S, int A, class F>
cudaError_t with_out(int out_depth, const F& f) {
  if constexpr (!tile_output<F>::value) {
    return out_depth == 0 ? f.template run<S, A, 0>() : kNotBuilt;
  } else {
    switch (out_depth) {
      case 1: return f.template run<S, A, 1>();
      case 2: return f.template run<S, A, 2>();
      case 3: return f.template run<S, A, 3>();
      case 4: return f.template run<S, A, 4>();
    }
    return kNotBuilt;
  }
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

// Host: a 2-D tensor map over `outer` rows of `inner` elements at `pitch`
// bytes, loading boxes of box_outer x box_inner.  cuTensorMapEncodeTiled is
// a driver function: it is fetched once through the runtime, so that no
// library links libcuda.
inline cudaError_t encode_tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                                        const void* base, uint64_t inner, uint64_t outer,
                                        uint64_t pitch, uint32_t box_inner,
                                        uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                  cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: does p start on 16 bytes (cp.async and bulk copies need it)?
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
