// Rodinia Needleman-Wunsch for Hopper: the (n+1) x (n+1) f32 DP table
//   m[i, j] = max(m[i-1, j-1] + s[i-1, j-1], m[i, j-1] - p, m[i-1, j] - p),
// with m[i, 0] = m[0, i] = -i p.
//
// Replaces src/repro/kernels/nw.py: nw_pallas (line 89), its body _nw_kernel
// (line 45) and its max-plus scan _cummax (line 33).  The reference is one
// program (grid=()) that carries the DP row across the whole width in VMEM.
// Here one launch of ceil(n / NW_STRIP) blocks cuts the table into column
// strips of NW_STRIP = 256 columns, one a thread (32 strips at n = 8192).
// Each block walks its whole strip from row 1 to row n as one tile stream
// of n / tile_rows tiles, so each strategy's ring warms up once a strip,
// and strip J + 1 follows strip J a tile or two behind.
//
// Bound: HBM bytes, n^2 * 4 of scores read and (n+1)^2 * 4 of table written
// once, at 4 operations a cell (0.16 ms at n = 8192).  The design does not
// reach it: a row is a chain (one block-wide scan), strip 0 runs all n rows
// and the last strip ends a few tiles a strip after it, so the time is
// about n row steps plus the per-tile work of n / tile_rows tiles.  What the
// design does about it: the score rows stream through the strategy's ring
// and the table rows drain through the bulk-store ring, so a strip's copies
// overlap its scans; the row step is kept short; and the hand-off between
// strips is read a tile ahead, off the chain.
//
// A row of a strip, as in the reference: c[j] = max(m[i-1, j-1] + s,
// m[i-1, j] - p) for the thread's one column j, then m[i, j] = max over
// k <= j of (c[k] - (j - k) p), seeded with m[i, J0-1], the left strip's
// last column: with t = c + j p this is an inclusive max-scan less j p.
// Thread 0 folds the seed into its t (max with seed - p); a shuffle scan
// runs in each warp, and lane 31 leaves its warp's maximum in shared
// memory.  After the row's one barrier each warp takes the maximum of the
// warps to its left in a fixed-depth tree (two 16-byte loads, 6 max), so
// every warp leaves the row at the same time.  A thread's next m[i-1, j-1]
// comes from its left lane's scan value, shuffled before the barrier (lane
// 0 of warp w: the left warps' maximum less (32 w - 1) p; thread 0: the
// seed).  The next row's score and seed are loaded before the barrier.
// Every value is an integer below 2^24, so the f32 table equals the oracle
// exactly.
//
// Strip order and hand-off:
//   * Thread 0 takes the block's strip from atomicAdd on a ticket, in the
//     order blocks start.  A strip waits only on the strip to its left,
//     whose block started before it, so the launch makes progress however
//     many blocks are resident (the dynamic tile id of single-pass
//     decoupled look-back scans, Merrill and Garland 2016).
//   * The edge buffer (nbc x n f32) holds each strip's last column by row.
//     The wrapper fills it with NaN; the thread of a strip's last column
//     stores m of each row there with st.relaxed.gpu.  m is never NaN, so
//     each value is its own flag: a 32-bit store is seen whole or not at
//     all, and no fence or progress counter is needed.
//   * Thread 0 of strip J + 1 reads the seeds of tile t + 1 with
//     ld.relaxed.gpu (never a plain load, which can hit a stale L1 line)
//     into registers at the top of tile t, and uses them at the top of
//     tile t + 1, reading again any that were still NaN.  So once a strip
//     has fallen two tiles behind its left neighbour, the hand-off costs
//     its rows nothing.  The seeds go to shared left[], which only thread
//     0 reads.  A seed never comes from the table, which the bulk-store
//     ring (the async proxy) writes later.  Tiles of more than kNwAhead
//     rows read their seeds when they start, kNwAhead at a time.
//   * The wait is bounded: after kSpinNs of %globaltimer it runs __trap(),
//     so a protocol fault fails the launch instead of hanging it.
//   * Workspace, allocated by the wrapper for each call on the call's
//     stream: the ticket (one int32, zero) and the edge buffer (NaN; 1 MiB
//     at n = 8192).
//
// Layout: the table is (n+1) rows of `tpitch` floats, table column j at
// float 3 + j of its row, so that column 1 + J NW_STRIP, where strip J
// starts, lies on 16 bytes, and so does column J NW_STRIP of the scores
// (s[i-1, j-1] belongs to cell (i, j)): no pass shifts the scores.  The
// wrapper fills row 0; strip 0 writes column 0.  The last strip may be
// ragged; copies and stores cover round4 of its columns, and the columns
// past n land in the row's padding.
//
// Barriers per tile (see async_pipeline.cuh for the loop):
//   SYNC            ld.global/st.shared staging, B1, seeds, tile_rows rows
//                   (one barrier each), fence, B2, store
//   REGISTER_BYPASS cp.async, wait_group 0, B1, seeds, rows, fence, B2,
//                   store
//   OVERLAP         issue i+A, wait_group A, B1, seeds, rows, fence, B2,
//                   store
//   DROP_OFF        wait_group A-1, B0 (a thread reads its column of every
//                   row, copied by other threads), read into registers,
//                   issue i+A, seeds, rows into the out slot, fence, B2,
//                   store
//   TMA             thread 0 expect-tx + one bulk load per row of i+A, all
//                   wait slot parity (i/depth)&1, B1, seeds, rows, fence,
//                   B2, store
#include <math_constants.h>

#include "async_pipeline.cuh"

namespace rt {

constexpr int NW_STRIP = kThreads;            // columns of a strip, one a thread
constexpr int kNwTileRows = 64;               // rows of a tile, at most
constexpr int kNwDropOffRows = 16;            // DROP_OFF: score rows held per thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kSpinNs = 1000000000u;     // a hand-off waits 1 s at most

// Shared memory: run_pipeline's [ring][out ring][TMA mbarriers], then at
// the next 16 bytes two sets of warp maxima (2 kWarps floats), the tile's
// seeds (kNwTileRows floats) and the strip index (an int, padded to 16).
__host__ __device__ constexpr int nw_extra_offset(int s, int out_depth, int depth,
                                                  int tile_rows) {
  return ((s == SYNC ? 1 : depth) * tile_rows * NW_STRIP * 4 +
          out_depth * tile_rows * NW_STRIP * 4 + (s == TMA ? 8 * depth : 0) + 15) &
         ~15;
}
constexpr int kNwExtra = (2 * kWarps + kNwTileRows) * 4 + 16;

__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;\n" :: "l"(p), "f"(v) : "memory");
}
// The low 32 bits of the global nanosecond timer (a wait measures at most
// kSpinNs, so unsigned differences stay right across a wrap).
__device__ __forceinline__ unsigned globaltimer_lo() {
  unsigned t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t));
  return t;
}
constexpr int kNwAhead = 8;                   // seeds read a tile ahead, at most

struct NwBody {
  static constexpr bool kCrossThreadReads = true;
  int rows;               // rows per tile
  int t;                  // the tile being computed
  float p, jp;            // the penalty, and j p for this thread's column
  float up, up_left;      // m[i-1, j] and m[i-1, j-1] for the next row i
  int extra;              // bytes into shared memory of the warp maxima
  const float* edge_in;   // the left strip's last column, m[i, J0-1] at [i-1]; NaN
                          // until written; null for strip 0
  float* edge_out;        // this strip's last column; null when no strip reads it
  int tiles;              // tiles of the strip
  float s[kNwDropOffRows];
  float ahead[kNwAhead];  // thread 0: the seeds of the tile after this one

  // Shared memory after the pipeline's, found from `extra` at each use (a
  // 32-bit offset in a register, where a pointer kept in the body would be
  // a 64-bit generic one): 2 x kWarps warp maxima, then the tile's seeds
  // m[i, J0-1], which only thread 0 reads.
  __device__ __forceinline__ float* wmax() const {
    return reinterpret_cast<float*>(smem + extra);
  }
  __device__ __forceinline__ float* left() const { return wmax() + 2 * kWarps; }

  __device__ __forceinline__ void fetch(int base, int count) {
#pragma unroll
    for (int k = 0; k < kNwAhead; ++k)
      if (k < count) ahead[k] = ld_relaxed(edge_in + base + k);
  }
  // Until no fetched seed is NaN (read again those that are), then into dst.
  __device__ __forceinline__ void settle(int base, int count, float* dst) {
    bool missing = false;
#pragma unroll
    for (int k = 0; k < kNwAhead; ++k) missing |= k < count && ahead[k] != ahead[k];
    if (missing) {
      const unsigned start = globaltimer_lo();
      do {
#pragma unroll
        for (int k = 0; k < kNwAhead; ++k)
          if (k < count && ahead[k] != ahead[k]) ahead[k] = ld_relaxed(edge_in + base + k);
        missing = false;
#pragma unroll
        for (int k = 0; k < kNwAhead; ++k) missing |= k < count && ahead[k] != ahead[k];
        if (missing && globaltimer_lo() - start > kSpinNs) __trap();
      } while (missing);
    }
#pragma unroll
    for (int k = 0; k < kNwAhead; ++k)
      if (k < count) dst[k] = ahead[k];
  }

  // Thread 0, before a tile's first row: the tile's seeds into left().
  __device__ __forceinline__ void seeds() {
    if (threadIdx.x != 0) return;
    const int i0 = t * rows;                 // the tile's rows are i0 + 1 + k
    if (edge_in == nullptr) {
      for (int k = 0; k < rows; ++k) left()[k] = -p * (i0 + 1 + k);
      return;
    }
    if (rows <= kNwAhead) {
      if (t == 0) fetch(0, rows);
      settle(i0, rows, left());
      if (t + 1 < tiles) fetch(i0 + rows, rows);
      return;
    }
    for (int k0 = 0; k0 < rows; k0 += kNwAhead) {
      const int count = min(kNwAhead, rows - k0);
      fetch(i0 + k0, count);
      settle(i0 + k0, count, left() + k0);
    }
  }
  // The writer's part of row k of the tile: its m to the edge buffer.
  __device__ __forceinline__ void edge(int k, float m) {
    if (edge_out != nullptr && threadIdx.x == NW_STRIP - 1) st_relaxed(edge_out + t * rows + k, m);
  }

  // Row k of the tile from this thread's score (and, for thread 0, the
  // row's seed); returns m[i, j].  The warp maxima alternate between two
  // sets by k, so a warp that runs ahead into row k + 1 does not overwrite
  // what a slower warp still reads of row k (rows k and k + 2 are a
  // barrier apart; so are a tile's last row and the next tile's first).
  __device__ __forceinline__ float row(float sc, float seed, int k) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float v = fmaxf(up_left + sc, up - p) + jp;
    if (threadIdx.x == 0) v = fmaxf(v, seed - p);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)   // lanes below off get their own v
      v = fmaxf(v, __shfl_up_sync(0xffffffffu, v, off));
    const float v_left = __shfl_up_sync(0xffffffffu, v, 1);
    float* wm = wmax() + (k & 1) * kWarps;
    if (lane == 31) wm[warp] = v;
    __syncthreads();
    const float4 a = reinterpret_cast<const float4*>(wm)[0];
    const float4 b = reinterpret_cast<const float4*>(wm)[1];
    const float none = -CUDART_INF_F;
    const float pre = fmaxf(fmaxf(fmaxf(warp > 0 ? a.x : none, warp > 1 ? a.y : none),
                                  fmaxf(warp > 2 ? a.z : none, warp > 3 ? a.w : none)),
                            fmaxf(fmaxf(warp > 4 ? b.x : none, warp > 5 ? b.y : none),
                                  warp > 6 ? b.z : none));
    const float m = fmaxf(v, pre) - jp;
    up_left = lane > 0 ? fmaxf(v_left, pre) - (jp - p)
                       : (warp == 0 ? seed : pre - (32 * warp - 1) * p);
    up = m;
    return m;
  }
  __device__ __forceinline__ void compute(const char* in, char* out) {
    const float* S = reinterpret_cast<const float*>(in) + threadIdx.x;
    float* Y = reinterpret_cast<float*>(out) + threadIdx.x;
    seeds();
    float sc = S[0];
    float seed = threadIdx.x == 0 ? left()[0] : 0.0f;
#pragma unroll 2
    for (int k = 0; k < rows; ++k) {
      const bool more = k + 1 < rows;
      const float sc_next = more ? S[(k + 1) * NW_STRIP] : 0.0f;
      const float seed_next = threadIdx.x == 0 && more ? left()[k + 1] : 0.0f;
      const float m = row(sc, seed, k);
      Y[k * NW_STRIP] = m;
      edge(k, m);
      sc = sc_next;
      seed = seed_next;
    }
    ++t;
  }
  __device__ __forceinline__ void load(const char* in) {
    const float* S = reinterpret_cast<const float*>(in);
#pragma unroll
    for (int k = 0; k < kNwDropOffRows; ++k)
      if (k < rows) s[k] = S[k * NW_STRIP + threadIdx.x];
  }
  __device__ __forceinline__ void store(char* out) {
    float* Y = reinterpret_cast<float*>(out) + threadIdx.x;
    seeds();
#pragma unroll
    for (int k = 0; k < kNwDropOffRows; ++k) {
      if (k < rows) {
        const float m = row(s[k], threadIdx.x == 0 ? left()[k] : 0.0f, k);
        Y[k * NW_STRIP] = m;
        edge(k, m);
      }
    }
    ++t;
  }
};

// One block per strip; `table` points at table column 0 of row 0.  One
// block an SM is all a strip needs: saying so lets ptxas take the
// registers the body needs, where with kThreads alone it kept 40-80 and
// spilled a few values, some inside the row loop.
template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads, 1)
nw_kernel(const float* scores, long long spitch, float* table, long long tpitch, int n,
          float p, int tile_rows, int depth, int* ticket, float* edge) {
  const int extra = nw_extra_offset(S, O, depth, tile_rows);
  int* strip = reinterpret_cast<int*>(smem + extra + (2 * kWarps + kNwTileRows) * 4);
  if (threadIdx.x == 0) *strip = atomicAdd(ticket, 1);
  __syncthreads();
  const int J = *strip;
  const int nbc = (n + NW_STRIP - 1) / NW_STRIP;
  const int j0 = 1 + J * NW_STRIP;                  // the strip's first column
  const int width = min(NW_STRIP, n + 1 - j0);
  const int w4 = (width + 3) & ~3;
  const int j = threadIdx.x;
  if (J == 0)
    for (int i = 1 + j; i <= n; i += kThreads) table[i * tpitch] = -p * i;
  const float* above = table + j0;                  // row 0, from the wrapper
  const bool feeds = J + 1 < nbc;
  NwBody body;
  body.rows = tile_rows;
  body.t = 0;
  body.p = p;
  body.jp = j * p;
  body.up = j < width ? above[j] : 0.0f;
  body.up_left = j < width ? above[j - 1] : 0.0f;
  body.extra = extra;
  body.edge_in = J > 0 ? edge + static_cast<long long>(J - 1) * n : nullptr;
  body.edge_out = feeds ? edge + static_cast<long long>(J) * n : nullptr;
  body.tiles = n / tile_rows;
  const Operand op[1] = {{reinterpret_cast<const char*>(scores + j0 - 1), 4 * spitch,
                          4 * tile_rows * spitch, tile_rows, 4 * w4, 4 * NW_STRIP}};
  const OutTile out{reinterpret_cast<const char*>(table + tpitch + j0), 4 * tpitch,
                    4 * tile_rows * tpitch, tile_rows, 4 * w4, 4 * NW_STRIP};
  run_pipeline<S, A, O>(body, op, out, n / tile_rows, depth);
}

struct NwLaunch {
  const float* scores;
  float* table;
  long long spitch, tpitch;
  int n, nbc, tile_rows, depth, smem;
  float p;
  int* ticket;
  float* edge;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (smem < nw_extra_offset(S, O, depth, tile_rows) + kNwExtra) return kNotBuilt;
    auto kernel = nw_kernel<S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<nbc, kThreads, smem, stream>>>(scores, spitch, table, tpitch, n, p, tile_rows,
                                            depth, ticket, edge);
    return cudaGetLastError();
  }
};

}  // namespace rt

// The whole table in one launch of ceil(n / 256) strips, enqueued on
// `stream` without synchronising.  scores: (n, spitch) f32; table: (n+1,
// tpitch) f32 whose float 3 + j holds column j, row 0 filled by the caller.
// Pitches are multiples of 4 with spitch >= round4(n) and tpitch >=
// round4(n) + 4; both arrays start on 16 bytes.  ticket: one int32, zero;
// edge: nedge >= nbc n f32, NaN.  Adds the launches it enqueued to
// *launched; returns a cudaError_t.  (Named apart from the anti-diagonal
// launcher it replaced, nw_launch, whose arguments differ, so that a
// library built from an older checkout is refused by name and never called
// with these.)
extern "C" int nw_strips_launch(int device, int strategy, int ahead, int out_depth,
                                int depth, const void* scores, int spitch, void* table,
                                int tpitch, int n, int penalty, int tile_rows, int smem,
                                void* ticket, void* edge, long long nedge, int* launched,
                                void* stream) {
  const int n4 = (n + 3) & ~3;
  const int nbc = (n + rt::NW_STRIP - 1) / rt::NW_STRIP;
  if (n < 1 || tile_rows < 1 || tile_rows > rt::kNwTileRows || n % tile_rows ||
      (spitch | tpitch) % 4 || spitch < n4 || tpitch < n4 + 4 || !rt::aligned16(scores) ||
      !rt::aligned16(table) || (strategy == rt::DROP_OFF && tile_rows > rt::kNwDropOffRows) ||
      ticket == nullptr || edge == nullptr || nedge < static_cast<long long>(nbc) * n)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = rt::dispatch(strategy, ahead, out_depth,
                   rt::NwLaunch{static_cast<const float*>(scores),
                                static_cast<float*>(table) + 3, spitch, tpitch, n, nbc,
                                tile_rows, depth, smem, static_cast<float>(penalty),
                                static_cast<int*>(ticket), static_cast<float*>(edge),
                                static_cast<cudaStream_t>(stream)});
  if (e != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}
