// Rodinia pathfinder for Hopper: the int32 row DP
//   dst[j] = wall[r, j] + min(prev[j-1], prev[j], prev[j+1]),
// neighbours clamped at the array's edges, over rows 1 .. rows-1 with row 0
// as the first prev; the result is the last row.
//
// Replaces src/repro/kernels/pathfinder.py: pathfinder_pallas (line 57) and
// its body _pathfinder_kernel (line 29).  The reference is one program
// (grid=()) that carries the whole DP row in VMEM.  Here one persistent
// launch cuts the row into column spans, one a block, and every block
// walks all rows - 1 DP rows of its span as one tile stream.
//
// Bound: HBM bytes.  The function reads the wall once, rows * cols * 4
// bytes, and writes one row; it does 3 integer operations a cell (0.1196 ms
// for (1001, 100000) at 3.35 TB/s).  What the design costs against that
// bound: each block reads PF_HALO halo columns on each side of its span
// (mostly from the L2: its neighbours read the same columns at about the
// same time), a hand-off every PF_HALO rows, and a row step that is a
// chain of 1,000 dependent rows.  What it does about the bound: the ring
// fills once a call and streams every row of the span, so the strategy
// keeps its copies in flight across step boundaries; the rows run in
// registers with no block-wide barrier a row.
//
// Spans (the plan, kernels/pathfinder.py `plan`): one block a span, and at
// most as many blocks as the card holds at once (cudaOccupancyMaxActive-
// BlocksPerMultiprocessor x SMs, at the shared memory of the widest region
// the spec fits), launched with cudaLaunchCooperativeKernel, which refuses
// a grid that is not all resident instead of letting it hang.  Span j owns
// columns [j W, (j+1) W), W = round4(cols / blocks) but at least 128 (SYNC,
// REGISTER_BYPASS) or 384 columns (the strategies that keep copies in
// flight while they compute, for which fewer, wider spans measured faster);
// the last span may be ragged.  Its region is the span and PF_HALO = H
// columns on each side, at most PF_REGION in all.  When cols needs more
// spans than blocks at the widest region, block b walks spans b, b + grid,
// ... (m of them) and the wrapper lays the wall out as tiles in that order
// (`tiles`); otherwise (m = 1) a block reads its region of the wall in
// place, clamped to the array.
//
// Steps and hand-off: a step is H DP rows.  At a step's start a block's
// region holds the right previous row; each row clamps at the region's
// edge, so after k rows the k columns next to each inner edge are wrong,
// and after H rows the span is right.  At the step's end the lanes that own
// the H edge columns on each side of the span write them to `edges` (two
// parities by step) as 64-bit (value, step) pairs with st.relaxed.gpu: a
// pair is written whole or not at all, so each value carries its own flag,
// as nw's NaN does, and no fence, barrier or counter is needed.  The lanes
// that hold the halo (H columns past each side of the span) read the
// neighbour's pairs with ld.relaxed.gpu (never a plain load, which can hit
// a stale L1 line) until all carry the step.  The wrapper zeroes `edges`,
// and steps count from 1.  A span can be at most one step ahead of a
// neighbour, so two parities suffice.  The wait is bounded: after
// kPfSpinNs of %globaltimer it runs __trap(), so a protocol fault fails the
// launch instead of hanging it.  nw's ticket order does not carry over: a
// span waits on both neighbours, so only co-residency guarantees progress.
// (A first design published through a flag a span, st.release.gpu after a
// barrier and ld.acquire.gpu then a second load: about 3 us a hand-off on
// the card, PERF.md section 6.)
//
// Row step: a lane holds PF_COLS = 4 adjacent columns in registers; its
// neighbours come by warp shuffle.  Warp w holds 128 columns of the region
// from 96 w - 16: it owns the middle 96 (PF_WARP_COLS), and 16 (PF_GHOST)
// on each side are ghosts of its neighbour warps' columns.  Every PF_GHOST
// rows the warps trade those edges through shared memory with one barrier
// (a warp-level ghost zone), so there is one block-wide barrier in 16 rows.
// A warp whose columns all lie outside the region and the array skips the
// rows and meets only the barriers.
// A column outside the region or the array holds INT_MAX and is never
// updated, which is the reference's clamp at the array's edges.  A lane
// reads its four wall values of a row as one int4 from the ring slot; the
// copies give the chunks of a tile to threads by chunk index, not by
// column, so every strategy's body reads chunks other threads copied
// (kCrossThreadReads true: DROP_OFF waits at a barrier before it reads
// its rows into registers).
//
// Barriers per tile (see async_pipeline.cuh for the loop; O = 0, no out ring),
// besides one per PF_GHOST rows and one per step:
//   SYNC            ld.global/st.shared staging, B1, tile_rows DP rows, B2
//   REGISTER_BYPASS cp.async, wait_group 0, B1, DP rows, B2
//   OVERLAP         issue i+A, wait_group A, B1, DP rows, B2
//   DROP_OFF        wait_group A-1, B0, read its columns of every row into
//                   registers, issue i+A, DP rows from registers, B2
//   TMA             thread 0 expect-tx + one bulk load per row of i+A, all
//                   wait slot parity (i/depth)&1, B1, DP rows, B2
#include <climits>

#include "async_pipeline.cuh"

namespace rt {

constexpr int PF_COLS = 4;                             // columns a lane: one int4
constexpr int PF_GHOST = 16;                           // ghost columns each side of a warp
constexpr int PF_HALO = 32;                            // H: halo columns; DP rows a step
constexpr int PF_WARP_COLS = 32 * PF_COLS - 2 * PF_GHOST;      // columns a warp owns
constexpr int PF_REGION = kThreads / 32 * PF_WARP_COLS;        // a span and its halos, at most
constexpr int kPfTileRows = 64;                        // rows of a tile, at most
constexpr int kPfDropOffRows = 16;                     // DROP_OFF: rows held per thread
constexpr int kPfGhostLanes = PF_GHOST / PF_COLS;
constexpr int kPfWarps = kThreads / 32;
constexpr int kPfExtra = 2 * kPfWarps * 2 * PF_GHOST * 4;      // the warps' edge buffers
constexpr unsigned kPfSpinNs = 1000000000u;            // a hand-off waits 1 s at most

static_assert(PF_HALO % PF_GHOST == 0 && PF_HALO % 4 == 0 &&
                  kPfDropOffRows <= PF_GHOST &&
                  (PF_GHOST & (PF_GHOST - 1)) == 0 && PF_GHOST % PF_COLS == 0,
              "steps end on a warp exchange; spans and halos start on 16 bytes");

// Shared memory: run_pipeline's [ring][TMA mbarriers] for tiles of `region`
// columns, then at the next 16 bytes the warps' edge buffers (two parities
// x kPfWarps x two sides x PF_GHOST ints).
__host__ __device__ constexpr int pf_extra_offset(int s, int depth, int tile_rows,
                                                  int region) {
  return ((s == SYNC ? 1 : depth) * tile_rows * region * 4 + (s == TMA ? 8 * depth : 0) +
          15) & ~15;
}

struct PfArgs {
  const int* prev;     // the row before the first DP row (round4(cols) ints)
  const int* wall;     // m = 1: the wall row of the first DP row, `pitch` ints a row
  const int* tiles;    // m > 1: the wrapper's tiles, [tile row][span][tile_rows][region]
  long long pitch;
  int* out;            // the last DP row, round4(cols) ints
  unsigned long long* edges;  // by span: two parities x (left, right) x PF_HALO
                              // (value, step) pairs, zero at first
  int4* save;          // m > 1: by span, kThreads lanes' columns between its tiles
  int cols, rows;      // rows: DP rows of this launch
  int tile_rows, depth, span, n_spans, m;
};

// Two (value, step) pairs, the value in the low 32 bits: each 64-bit
// element is read and written whole.
__device__ __forceinline__ void pf_st_pairs(unsigned long long* p, int x, int y, int step) {
  const unsigned long long hi = static_cast<unsigned long long>(step) << 32;
  asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};\n"
               :: "l"(p), "l"(hi | static_cast<unsigned>(x)),
                  "l"(hi | static_cast<unsigned>(y)) : "memory");
}
__device__ __forceinline__ void pf_ld_pairs(const unsigned long long* p,
                                            unsigned long long& x, unsigned long long& y) {
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];\n"
               : "=l"(x), "=l"(y) : "l"(p) : "memory");
}
__device__ __forceinline__ unsigned pf_globaltimer_lo() {
  unsigned t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t));
  return t;
}
// The four values at p once all four pairs carry `step`; a wait of more
// than kPfSpinNs traps.
__device__ __forceinline__ int4 pf_take(const unsigned long long* p, int step) {
  const unsigned long long want = static_cast<unsigned long long>(step);
  unsigned long long x, y, z, w;
  pf_ld_pairs(p, x, y);
  pf_ld_pairs(p + 2, z, w);
  bool ready = (x >> 32) == want && (y >> 32) == want && (z >> 32) == want &&
               (w >> 32) == want;
  if (!ready) {
    const unsigned start = pf_globaltimer_lo();
    do {
      pf_ld_pairs(p, x, y);
      pf_ld_pairs(p + 2, z, w);
      ready = (x >> 32) == want && (y >> 32) == want && (z >> 32) == want &&
              (w >> 32) == want;
      if (!ready && pf_globaltimer_lo() - start > kPfSpinNs) __trap();
    } while (!ready);
  }
  return make_int4(static_cast<int>(x), static_cast<int>(y), static_cast<int>(z),
                   static_cast<int>(w));
}

struct PathfinderBody {
  static constexpr bool kCrossThreadReads = true;
  const PfArgs* a;
  int tile;            // tiles this block has begun
  int spitch;          // bytes of a tile row in shared memory
  int extra;           // bytes into shared memory of the warps' edge buffers
  int j, r0;           // the tile's span, and the DP rows before the tile
  bool idle;           // m > 1: a span past the last (its tiles are padding)
  bool last;           // the span's last tile
  bool busy;           // this warp holds a column of the region and the array
  bool whole;          // ... and no other
  int x;               // this lane's first column
  int off;             // its bytes into a tile row
  unsigned live;       // bit k: column x + k lies in the region and the array
  int v[PF_COLS];
  int4 held[kPfDropOffRows];

  __device__ __forceinline__ void set(int4 t) {
    v[0] = live & 1 ? t.x : INT_MAX;
    v[1] = live & 2 ? t.y : INT_MAX;
    v[2] = live & 4 ? t.z : INT_MAX;
    v[3] = live & 8 ? t.w : INT_MAX;
  }
  __device__ __forceinline__ int4 get() const { return make_int4(v[0], v[1], v[2], v[3]); }

  // Tile i: its span and DP rows; at a span's first tile, its geometry and
  // the previous row; at a later tile of m > 1, the lanes' saved columns.
  __device__ __forceinline__ void begin() {
    const int q = tile % a->m, R = tile / a->m;
    const int tiles = a->rows / a->tile_rows;
    j = blockIdx.x + q * gridDim.x;
    r0 = R * a->tile_rows;
    last = R + 1 == tiles;
    idle = j >= a->n_spans;
    if (idle || (a->m == 1 && R > 0)) return;
    const int x0 = j * a->span - PF_HALO;
    const int region = a->span + 2 * PF_HALO;
    const int lo = max(x0, 0), hi = min(x0 + region, a->cols);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    x = x0 + warp * PF_WARP_COLS - PF_GHOST + lane * PF_COLS;
    live = 0;
#pragma unroll
    for (int k = 0; k < PF_COLS; ++k) live |= (x + k >= lo && x + k < hi ? 1u : 0u) << k;
    busy = __any_sync(0xffffffffu, live != 0);
    whole = __all_sync(0xffffffffu, live == 0xfu);
    // m = 1 reads the region clamped to the array, from lo; m > 1 the
    // wrapper's tile of the whole region, from x0
    const int t0 = a->m == 1 ? lo : x0;
    const int w4 = a->m == 1 ? (hi - lo + 3) & ~3 : region;
    off = 4 * min(max(x - t0, 0), w4 - PF_COLS);
    if (R == 0)
      set(live ? *reinterpret_cast<const int4*>(a->prev + x) : make_int4(0, 0, 0, 0));
    else
      set(a->save[static_cast<long long>(j) * kThreads + threadIdx.x]);
  }
  // After a span's tile: its owned columns to `out` (the last tile) or the
  // lanes' columns to `save` (m > 1).
  __device__ __forceinline__ void end() {
    const int lane = threadIdx.x & 31;
    if (last) {
      const int rel = x - j * a->span;
      if (lane >= kPfGhostLanes && lane < 32 - kPfGhostLanes && rel >= 0 && rel < a->span &&
          x < ((a->cols + 3) & ~3))
        *reinterpret_cast<int4*>(a->out + x) = get();
    } else if (a->m > 1) {
      a->save[static_cast<long long>(j) * kThreads + threadIdx.x] = get();
    }
  }

  // Step k's end: this span's edges out, the neighbours' edges in.
  __device__ __forceinline__ void handoff(int k) {
    const int lane = threadIdx.x & 31;
    const bool owner = lane >= kPfGhostLanes && lane < 32 - kPfGhostLanes;
    const int rel = x - j * a->span;
    const bool left = j > 0, right = j + 1 < a->n_spans;
    const long long par = k & 1;
    unsigned long long* mine = a->edges + (j * 2 + par) * 2 * PF_HALO;
    unsigned long long* at = nullptr;
    if (owner && left && rel >= 0 && rel < PF_HALO) at = mine + rel;
    if (owner && right && rel >= a->span - PF_HALO && rel < a->span)
      at = mine + PF_HALO + rel - (a->span - PF_HALO);
    if (at != nullptr) {
      pf_st_pairs(at, v[0], v[1], k);
      pf_st_pairs(at + 2, v[2], v[3], k);
    }
    if (owner && left && rel >= -PF_HALO && rel < 0)
      set(pf_take(a->edges + ((j - 1) * 2 + par) * 2 * PF_HALO + PF_HALO + rel + PF_HALO, k));
    if (owner && right && rel >= a->span && rel < a->span + PF_HALO)
      set(pf_take(a->edges + ((j + 1) * 2 + par) * 2 * PF_HALO + rel - a->span, k));
  }
  // Every PF_GHOST rows: each warp's owned edges to shared memory, one
  // barrier, its ghosts from its neighbours' edges.  Two parities: a warp
  // writes a buffer again only after the barrier of the next exchange,
  // which every reader of this one has passed.
  __device__ __forceinline__ void exchange(int rr) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int4* buf = reinterpret_cast<int4*>(smem + extra) +
                ((rr / PF_GHOST) & 1) * kPfWarps * 2 * kPfGhostLanes;
    if (lane >= kPfGhostLanes && lane < 2 * kPfGhostLanes)
      buf[warp * 2 * kPfGhostLanes + lane - kPfGhostLanes] = get();
    if (lane >= 32 - 2 * kPfGhostLanes && lane < 32 - kPfGhostLanes)
      buf[(warp * 2 + 1) * kPfGhostLanes + lane - (32 - 2 * kPfGhostLanes)] = get();
    __syncthreads();
    if (lane < kPfGhostLanes && warp > 0)
      set(buf[((warp - 1) * 2 + 1) * kPfGhostLanes + lane]);
    if (lane >= 32 - kPfGhostLanes && warp + 1 < kPfWarps)
      set(buf[(warp + 1) * 2 * kPfGhostLanes + lane - (32 - kPfGhostLanes)]);
  }
  // The next DP row from its wall values w.
  __device__ __forceinline__ void row(int4 w) {
    const int l = __shfl_up_sync(0xffffffffu, v[3], 1);
    const int r = __shfl_down_sync(0xffffffffu, v[0], 1);
    const int m01 = min(v[0], v[1]), m12 = min(v[1], v[2]), m23 = min(v[2], v[3]);
    const int n0 = w.x + min(l, m01), n1 = w.y + min(m01, v[2]);
    const int n2 = w.z + min(m12, v[3]), n3 = w.w + min(m23, r);
    if (whole) {
      v[0] = n0, v[1] = n1, v[2] = n2, v[3] = n3;
    } else {
      v[0] = live & 1 ? n0 : INT_MAX;
      v[1] = live & 2 ? n1 : INT_MAX;
      v[2] = live & 4 ? n2 : INT_MAX;
      v[3] = live & 8 ? n3 : INT_MAX;
    }
  }
  // After DP row rr (1-based in the launch): the warps' exchange every
  // PF_GHOST rows, after the step's hand-off every PF_HALO rows.
  __device__ __forceinline__ void after(int rr) {
    if ((rr & (PF_GHOST - 1)) == 0 && rr < a->rows) {
      if (rr % PF_HALO == 0) handoff(rr / PF_HALO);
      exchange(rr);
    }
  }

  __device__ __forceinline__ void compute(const char* in, char*) {
    begin();
    if (!idle && !busy) {     // the rows' barriers only
      for (int rr = (r0 / PF_GHOST + 1) * PF_GHOST; rr <= r0 + a->tile_rows; rr += PF_GHOST)
        after(rr);
      end();
    } else if (!idle) {
      const char* p = in + off;
      int4 w = *reinterpret_cast<const int4*>(p);
      for (int k = 0; k < a->tile_rows;) {
        // the rows up to the next exchange or the tile's end, then after()
        const int seg = min(a->tile_rows - k, PF_GHOST - ((r0 + k) & (PF_GHOST - 1)));
        for (int q = 0; q < seg; ++q, ++k) {
          const int4 next = k + 1 < a->tile_rows
                                ? *reinterpret_cast<const int4*>(p + (k + 1) * spitch)
                                : w;
          row(w);
          w = next;
        }
        after(r0 + k);
      }
      end();
    }
    ++tile;
  }
  __device__ __forceinline__ void load(const char* in) {
    begin();
    if (idle || !busy) return;
#pragma unroll
    for (int k = 0; k < kPfDropOffRows; ++k)
      if (k < a->tile_rows) held[k] = *reinterpret_cast<const int4*>(in + off + k * spitch);
  }
  // The rows from registers.  A tile of at most kPfDropOffRows <= PF_GHOST
  // rows holds at most one exchange, after its row ks: the rows before it
  // and after it are two unrolled passes, so that one copy of the exchange
  // is inlined, not one a row.
  __device__ __forceinline__ void store(char*) {
    if (!idle) {
      const int ks = PF_GHOST - 1 - (r0 & (PF_GHOST - 1));
#pragma unroll
      for (int k = 0; k < kPfDropOffRows; ++k)
        if (busy && k < a->tile_rows && k <= ks) row(held[k]);
      if (ks < a->tile_rows) after(r0 + ks + 1);
#pragma unroll
      for (int k = 0; k < kPfDropOffRows; ++k)
        if (busy && k < a->tile_rows && k > ks) row(held[k]);
      end();
    }
    ++tile;
  }
};

// One block walks its spans (one, or m interleaved by tile row) from the
// first DP row to the last as one tile stream.  Two blocks an SM at least:
// saying so lets ptxas take the registers DROP_OFF's rows need, where with
// kThreads alone it spilled a few bytes in TMA's deeper rings.
template <int S, int A, int O>
__global__ void __launch_bounds__(kThreads, 2)
pathfinder_spans_kernel(const __grid_constant__ PfArgs a) {
  const int region = a.span + 2 * PF_HALO;
  PathfinderBody body;
  body.a = &a;
  body.tile = 0;
  body.spitch = 4 * region;
  body.extra = pf_extra_offset(S, a.depth, a.tile_rows, region);
  body.idle = false;
  // m = 1: the block's region of the wall in place, clamped to the array;
  // m > 1: tile i of this block is tile i * grid + blockIdx.x of `tiles`
  const int x0 = static_cast<int>(blockIdx.x) * a.span - PF_HALO;
  const int lo = max(x0, 0), hi = min(x0 + region, a.cols);
  const bool one = a.m == 1;
  const char* g = one ? reinterpret_cast<const char*>(a.wall + lo)
                      : reinterpret_cast<const char*>(a.tiles) +
                            4LL * blockIdx.x * a.tile_rows * region;
  const Operand op[1] = {{g, one ? 4 * a.pitch : 4LL * region,
                          one ? 4 * a.tile_rows * a.pitch
                              : 4LL * gridDim.x * a.tile_rows * region,
                          a.tile_rows, one ? 4 * ((hi - lo + 3) & ~3) : 4 * region,
                          4 * region}};
  run_pipeline<S, A, O>(body, op, op[0], a.rows / a.tile_rows * a.m, a.depth);
}

struct PathfinderLaunch {
  static constexpr bool kTileOutput = false;
  PfArgs a;
  int grid, smem;
  cudaStream_t stream;

  template <int S, int A, int O>
  cudaError_t run() const {
    if (smem < pf_extra_offset(S, a.depth, a.tile_rows, a.span + 2 * PF_HALO) + kPfExtra)
      return kNotBuilt;
    auto kernel = pathfinder_spans_kernel<S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    PfArgs args = a;
    void* params[] = {&args};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                       dim3(kThreads), params, smem, stream);
  }
};

// The blocks of one instantiation the card holds at once at `smem` bytes.
struct PathfinderBlocks {
  static constexpr bool kTileOutput = false;
  int smem;
  int* blocks;

  template <int S, int A, int O>
  cudaError_t run() const {
    auto kernel = pathfinder_spans_kernel<S, A, O>;
    cudaError_t e = ensure_smem(kernel, smem);
    int per_sm = 0, device = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    *blocks = per_sm * sms;
    return e;
  }
};

}  // namespace rt

// *blocks: how many blocks of the (strategy, ahead) kernel the card holds at
// once with `smem` bytes of shared memory each (what one launch may run).
extern "C" int pathfinder_blocks(int device, int strategy, int ahead, int smem, int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  *blocks = 0;
  return rt::dispatch(strategy, ahead, 0, rt::PathfinderBlocks{smem, blocks});
}

// The whole DP in one cooperative launch of `grid` blocks, each walking m
// spans of `span` columns (kernels/pathfinder.py `plan`), enqueued on
// `stream` without synchronising.  wall: (rows, pitch) int32, pitch a
// multiple of 4 >= cols, 16-byte aligned; out: round4(cols) int32.  m > 1:
// tiles, the wall's rows 1.. laid out [tile row][span][tile_rows][region]
// over grid * m spans, region = span + 2 PF_HALO, and save, grid * m *
// kThreads int4.  edges: nedges >= grid * m * 4 PF_HALO 64-bit pairs,
// zero.  Adds the launches it enqueued to *launched; returns a
// cudaError_t (cudaErrorCooperativeLaunchTooLarge for a grid the card does
// not hold at once).  (Named apart from the pyramid launcher it replaced,
// pathfinder_launch, whose arguments differ, so that a library built from
// an older checkout is refused by name and never called with these.)
extern "C" int pathfinder_spans_launch(int device, int strategy, int ahead, int depth,
                                       const void* wall, int pitch, int rows, int cols,
                                       int tile_rows, int span, int grid, int m,
                                       const void* tiles, void* out, void* edges,
                                       long long nedges, void* save, int smem, int* launched,
                                       void* stream) {
  const long long spans = static_cast<long long>(grid) * m;
  const int n_spans = span > 0 ? (cols + span - 1) / span : 0;
  if (rows < 2 || cols < 1 || tile_rows < 1 || tile_rows > rt::kPfTileRows ||
      (rows - 1) % tile_rows || pitch % 4 || pitch < cols || !rt::aligned16(wall) ||
      !rt::aligned16(out) ||
      (strategy == rt::DROP_OFF && tile_rows > rt::kPfDropOffRows) || span % 4 ||
      span < rt::PF_HALO || span + 2 * rt::PF_HALO > rt::PF_REGION || grid < 1 || m < 1 ||
      n_spans > spans || (m == 1 && grid != n_spans) || edges == nullptr ||
      !rt::aligned16(edges) ||
      nedges < spans * 4 * rt::PF_HALO ||
      (m > 1 && (tiles == nullptr || save == nullptr || !rt::aligned16(tiles) ||
                 !rt::aligned16(save))))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int* w = static_cast<const int*>(wall);
  const rt::PfArgs a{w,
                     w + pitch,
                     static_cast<const int*>(tiles),
                     pitch,
                     static_cast<int*>(out),
                     static_cast<unsigned long long*>(edges),
                     static_cast<int4*>(save),
                     cols,
                     rows - 1,
                     tile_rows,
                     depth,
                     span,
                     n_spans,
                     m};
  e = rt::dispatch(strategy, ahead, 0,
                   rt::PathfinderLaunch{a, grid, smem, static_cast<cudaStream_t>(stream)});
  if (e != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}
