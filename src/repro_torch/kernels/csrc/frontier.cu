// One level of queue-driven BFS for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/frontier.py:_frontier_kernel,
// which walks the frontier in one sequential loop: for each frontier
// vertex in order (-1 slots skipped) and each of its CSR neighbours in
// order, mark the neighbour visited and, if it was unvisited, write it at
// ticket = running count, clamped to max_out - 1.  Here the level runs in
// parallel, in three launches and with nothing read back, and the output
// is the same, bit for bit:
//
//   1. offsets: a decoupled look-back scan (lookback.cuh) of the frontier
//      slots' degrees (0 for -1) gives each slot its row end (inclusive
//      offset) and its column base (row_ptr[u] - exclusive offset), so
//      edge p of the sequential stream is col[colbase[i] + p] for the slot
//      i with rowend[i - 1] <= p < rowend[i].  The last tile leaves the
//      level's edge count E in device memory.
//   2. claim: a grid sized from the card loops over chunks of the merged
//      (slot ends, edges) sequence, kChunkItems items each, found by one
//      merge-path search per chunk end; the chunk's row ends and column
//      bases are staged in shared memory and each edge finds its slot
//      there.  An edge whose target v is unvisited takes part in
//      atomicMin(first[v], p); lanes of a warp with the same target
//      (__match_any_sync) send one atomic, their least p.  first[] is an
//      (n,) scratch plane of INT_MAX kept by the caller.  This launch also
//      resets to -1 the prefix of the output buffer that its last use
//      wrote (its length is kept in the buffer's last word).
//   3. emit: tiles of chunks, in ticket order, test each edge (fresh iff
//      first[v] == p: only unvisited targets were claimed, so that is the
//      first occurrence of an unvisited vertex in the stream, the edge the
//      sequential loop finds fresh), rank the fresh edges with a block
//      scan and a decoupled look-back over the tiles, and write each at its
//      rank r: out[r] when r < max_out - 1; ranks at or past max_out - 1
//      go through a 64-bit atomicMax of (r, v), so the last fresh vertex
//      wins the last slot
//      (the Pallas clamp).  A fresh edge sets visited[v] = 1 and resets
//      first[v] to INT_MAX, so first[] is all INT_MAX again after every
//      level with no O(n) pass.  The block that finishes last writes the
//      count, the last slot and the buffer's written length, and leaves
//      the scratch zero but for the edge count: a block of the launch
//      that starts after it still reads that count, finds itself past the
//      tiles and returns.
//
// The claim must be complete grid-wide before any edge tests first[v] ==
// p, so claim and emit are two launches.  Only a winner writes its
// vertex's visited and first words, and a non-winner is never fresh
// whatever it reads there, so the fresh test and the emit can share one
// pass while first changes.
//
// Bound: bytes.  Per level the frontier and its distinct row_ptr words
// are read, per scanned edge its col word, and per distinct target its
// visited word (once, however many edges reach it); per fresh vertex its
// visited word is written, and the count (the scratch traffic, the
// staging and the searches are not counted).  Measured (chip_smoke.py
// phase 7, NVIDIA H100 80GB HBM3, 700.00 W): 387 us at kron 2^20's busiest
// level (11.8 M edges; bound 18 us), where each edge's target words are
// random 4-byte reads and atomics in L2; 33-35 us a level on road, where
// three launches and their chains of dependent L2 round trips (ticket,
// merge-path rounds, staging, look-back) are all there is.  The design
// this replaces (seven launches, a readback to size the grid, an O(n)
// output fill) took 865 us at the kron level, its readback included.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lookback.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kItems = 8;                         // per thread
constexpr int kChunkItems = kThreads * kItems;    // merged items per chunk
constexpr int kOffTile = kThreads * kItems;       // frontier slots per tile
constexpr int kEmitTiles = 32768;                 // status words of launch 3
constexpr int kBlocksPerSm = 8;

// Scratch after the (n,) first plane, 8-byte aligned, zero between calls
// apart from `edges`: counters, the level's edge count, the overflow
// winner, then the status words of launches 1 and 3.
struct FrontierState {
  unsigned int ticket1, done1, ticket3, done3;
  int32_t edges;
  int32_t pad[3];
  unsigned long long overflow;  // ((r + 1) << 32) | v of the largest r
  unsigned long long pad2;
  unsigned long long status[1];  // kEmitTiles for launch 3, then launch 1's
};

// Tile id from a ticket counter, broadcast to the block.
__device__ __forceinline__ int take_ticket(unsigned int* ticket) {
  __shared__ int s_tile;
  __syncthreads();  // s_tile of the previous ticket has been read
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  return s_tile;
}

// True in every thread of the one block that finishes last of `blocks`.
__device__ __forceinline__ bool finished_last(unsigned int* done,
                                              int blocks) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1u) == static_cast<unsigned int>(blocks - 1);
    __threadfence();
  }
  __syncthreads();
  return s_last;
}

// ---- launch 1: row ends and column bases --------------------------------

__global__ void __launch_bounds__(kThreads)
    offsets_kernel(const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ frontier,
                   uint32_t* __restrict__ rowend,
                   uint32_t* __restrict__ colbase,
                   FrontierState* __restrict__ st,
                   int32_t* __restrict__ edges_out, int f) {
  __shared__ uint32_t s_base;
  unsigned long long* status = st->status + kEmitTiles;
  const int tile = take_ticket(&st->ticket1);
  const int ntiles = gridDim.x;
  const int64_t i0 = static_cast<int64_t>(tile) * kOffTile +
                     static_cast<int64_t>(threadIdx.x) * kItems;
  uint32_t deg[kItems], start[kItems], sum = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    deg[q] = 0;
    start[q] = 0;
    if (i0 + q < f) {
      const int32_t u = frontier[i0 + q];
      if (u >= 0) {
        start[q] = static_cast<uint32_t>(row_ptr[u]);
        deg[q] = static_cast<uint32_t>(row_ptr[u + 1]) - start[q];
      }
    }
    sum += deg[q];
  }
  uint32_t tile_count;
  const uint32_t before = block_exclusive_sum(sum, &tile_count);
  if (threadIdx.x < 32) {
    const uint32_t base = lookback_base(st->status + kEmitTiles, tile,
                                        tile_count);
    if (threadIdx.x == 0) s_base = base;
  }
  __syncthreads();
  uint32_t run = s_base + before;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (i0 + q < f) {
      colbase[i0 + q] = start[q] - run;
      run += deg[q];
      rowend[i0 + q] = run;
    }
  }
  if (tile == ntiles - 1 && threadIdx.x == 0) {
    st->edges = static_cast<int32_t>(s_base + tile_count);
    edges_out[0] = static_cast<int32_t>(s_base + tile_count);
  }
  if (finished_last(&st->done1, ntiles)) {
    for (int t = threadIdx.x; t < ntiles; t += kThreads) status[t] = 0ull;
    if (threadIdx.x == 0) {
      st->ticket1 = 0u;
      st->done1 = 0u;
    }
  }
}

// ---- merged (row end, edge) chunks ---------------------------------------

struct Chunk {
  int x0;      // first slot of the chunk
  int nslots;  // slots staged: x0 .. x0 + nslots - 1
  uint32_t y0; // first edge
  uint32_t y1; // one past the last edge
};

// Merge-path split of diagonal d of the merge of rowend[0..f) with the
// edge indices 0..E-1: the slots consumed (a row end precedes edge p when
// rowend <= p), found by the whole block: each round tests kThreads evenly
// spaced candidates at once and keeps the span between the last that
// precedes and the first that does not, so a split costs two or three
// rounds of loads, not a binary search's chain of them.  Every thread of
// the block must call it; all get the split.
__device__ __forceinline__ int merge_split(const uint32_t* rowend, int f,
                                           uint32_t e, int64_t d) {
  int64_t lo = d - e > 0 ? d - e : 0;
  int64_t hi = d < f ? d : f;  // the split is in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + kThreads - 1) / kThreads;
    const int64_t pos = lo + threadIdx.x * step;
    const bool before =
        pos < hi && static_cast<int64_t>(rowend[pos]) <= d - pos - 1;
    const int n = __syncthreads_count(before);  // a prefix of candidates
    const int64_t next_hi = lo + n * step;
    lo = n ? lo + (n - 1) * step + 1 : lo;
    hi = next_hi < hi ? next_hi : hi;
  }
  return static_cast<int>(lo);
}

// Stages chunk c's row ends and column bases (slots x0 .. min(x1, f - 1))
// in shared memory.  Every thread of the block must call it.
__device__ __forceinline__ Chunk stage_chunk(const uint32_t* rowend,
                                             const uint32_t* colbase, int f,
                                             uint32_t e, int64_t nitems,
                                             int64_t c, uint32_t* s_end,
                                             uint32_t* s_base) {
  const int64_t d0 = c * kChunkItems;
  const int64_t d1 = d0 + kChunkItems < nitems ? d0 + kChunkItems : nitems;
  const int x0 = merge_split(rowend, f, e, d0);
  const int x1 = merge_split(rowend, f, e, d1);
  __syncthreads();  // the previous chunk's staging has been read
  const int last = x1 < f - 1 ? x1 : f - 1;
  for (int q = threadIdx.x; q <= last - x0; q += kThreads) {
    s_end[q] = rowend[x0 + q];
    s_base[q] = colbase[x0 + q];
  }
  __syncthreads();
  return {x0, last - x0 + 1, static_cast<uint32_t>(d0 - x0),
          static_cast<uint32_t>(d1 - x1)};
}

// The staged slot (offset from x0) of edge p: the first with row end > p.
__device__ __forceinline__ int slot_of(const uint32_t* s_end, int n,
                                       uint32_t p) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t chunk_count(int f, uint32_t e) {
  return (static_cast<int64_t>(f) + e + kChunkItems - 1) / kChunkItems;
}

// ---- launch 2: claim ------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    claim_kernel(const int32_t* __restrict__ col,
                 const uint32_t* __restrict__ rowend,
                 const uint32_t* __restrict__ colbase,
                 const int32_t* __restrict__ visited,
                 int32_t* __restrict__ first,
                 const FrontierState* __restrict__ st,
                 int32_t* __restrict__ out, int f, int max_out) {
  __shared__ uint32_t s_end[kChunkItems + 1], s_base[kChunkItems + 1];
  // the prefix the buffer's last use wrote goes back to -1
  const int written = out[max_out];
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < written;
       q += gridDim.x * kThreads)
    out[q] = -1;
  const uint32_t e = static_cast<uint32_t>(st->edges);
  const int64_t nitems = static_cast<int64_t>(f) + e;
  const int64_t nchunks = chunk_count(f, e);
  const uint32_t lane = threadIdx.x & 31u;
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const Chunk ch = stage_chunk(rowend, colbase, f, e, nitems, c, s_end,
                                 s_base);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const uint32_t p = ch.y0 + q * kThreads + threadIdx.x;
      int32_t v = -1;
      if (p < ch.y1) {
        const int s = slot_of(s_end, ch.nslots, p);
        const int32_t t = col[s_base[s] + p];
        if (visited[t] == 0) v = t;
      }
      // one atomic per warp and target: its least stream position
      const unsigned peers = __match_any_sync(0xffffffffu, v);
      if (v >= 0 && lane == static_cast<uint32_t>(__ffs(peers) - 1))
        atomicMin(first + v, static_cast<int32_t>(p));
    }
  }
}

// ---- launch 3: fresh test, rank and emit ---------------------------------

// Fresh flags of the chunk's edges, kItems consecutive edges per thread:
// bit q of the result and v[q] for edge y0 + threadIdx.x * kItems + q.
// Only unvisited targets were claimed and only a winner changes its
// target's words, so first[v] == p alone says the edge is fresh: the
// visited map is not read here.  first changes during this launch
// (winners only), so these are plain loads.
__device__ __forceinline__ uint32_t fresh_bits(const int32_t* col,
                                               const int32_t* first,
                                               const Chunk& ch,
                                               const uint32_t* s_end,
                                               const uint32_t* s_base,
                                               int32_t* v) {
  uint32_t bits = 0;
  const uint32_t p0 = ch.y0 + threadIdx.x * kItems;
  int s = p0 < ch.y1 ? slot_of(s_end, ch.nslots, p0) : 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const uint32_t p = p0 + q;
    v[q] = 0;
    if (p < ch.y1) {
      while (s_end[s] <= p) ++s;
      const int32_t t = col[s_base[s] + p];
      v[q] = t;
      if (first[t] == static_cast<int32_t>(p)) bits |= 1u << q;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(const int32_t* __restrict__ col,
                const uint32_t* __restrict__ rowend,
                const uint32_t* __restrict__ colbase, int32_t* visited,
                int32_t* first, FrontierState* __restrict__ st,
                int32_t* __restrict__ out, int32_t* __restrict__ count,
                int f, int max_out) {
  __shared__ uint32_t s_end[kChunkItems + 1], s_base[kChunkItems + 1];
  __shared__ uint32_t s_prefix;
  const uint32_t e = static_cast<uint32_t>(st->edges);
  const int64_t nitems = static_cast<int64_t>(f) + e;
  const int64_t nchunks = chunk_count(f, e);
  // chunks per tile, so that the tiles fit the status words
  const int64_t per = (nchunks + kEmitTiles - 1) / kEmitTiles;
  const int ntiles = static_cast<int>((nchunks + per - 1) / per);
  const int active = ntiles < static_cast<int>(gridDim.x)
                         ? ntiles : static_cast<int>(gridDim.x);
  if (static_cast<int>(blockIdx.x) >= active) return;
  const uint32_t last = static_cast<uint32_t>(max_out - 1);
  while (true) {
    const int tile = take_ticket(&st->ticket3);
    if (tile >= ntiles) break;
    const int64_t c0 = tile * per;
    const int64_t c1 = c0 + per < nchunks ? c0 + per : nchunks;
    // pass 1: the tile's fresh count (one chunk: flags kept)
    uint32_t bits = 0, tile_count = 0;
    int32_t v[kItems];
    for (int64_t c = c0; c < c1; ++c) {
      const Chunk ch = stage_chunk(rowend, colbase, f, e, nitems, c, s_end,
                                   s_base);
      bits = fresh_bits(col, first, ch, s_end, s_base, v);
      uint32_t total;
      block_exclusive_sum(__popc(bits), &total);
      tile_count += total;
    }
    if (threadIdx.x < 32) {
      const uint32_t base = lookback_base(st->status, tile, tile_count);
      if (threadIdx.x == 0) s_prefix = base;
    }
    __syncthreads();
    uint32_t run = s_prefix;
    // pass 2: rank and emit (several chunks: flags found again)
    for (int64_t c = c0; c < c1; ++c) {
      if (c1 - c0 > 1) {
        const Chunk ch = stage_chunk(rowend, colbase, f, e, nitems, c, s_end,
                                     s_base);
        bits = fresh_bits(col, first, ch, s_end, s_base, v);
      }
      uint32_t total;
      uint32_t r = run + block_exclusive_sum(__popc(bits), &total);
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (!((bits >> q) & 1u)) continue;
        if (r < last) {
          out[r] = v[q];
        } else {
          atomicMax(&st->overflow,
                    (static_cast<unsigned long long>(r + 1u) << 32) |
                        static_cast<uint32_t>(v[q]));
        }
        visited[v[q]] = 1;
        first[v[q]] = INT_MAX;
        ++r;
      }
      run += total;
    }
  }
  if (finished_last(&st->done3, active)) {
    if (threadIdx.x == 0) {
      const uint32_t total = wait_inclusive(st->status, ntiles - 1);
      count[0] = static_cast<int32_t>(total);
      const unsigned long long w =
          *static_cast<volatile unsigned long long*>(&st->overflow);
      if (w) out[last] = static_cast<int32_t>(static_cast<uint32_t>(w));
      out[max_out] = static_cast<int32_t>(
          total < static_cast<uint32_t>(max_out) ? total : max_out);
      st->overflow = 0ull;
      st->ticket3 = 0u;
      st->done3 = 0u;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < ntiles; t += kThreads) st->status[t] = 0ull;
  }
}

int grid_blocks() {
  static int blocks = 0;
  if (!blocks) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = (sms > 0 ? sms : 1) * kBlocksPerSm;
  }
  return blocks;
}

}  // namespace repro

// One BFS level in three launches, nothing read back.
// row_ptr: (n+1,); col: (m,); frontier: (f,), f > 0, at most
// kOffTile * tiles1 slots; visited: (n,) updated in place; state: the
// FrontierState after the (n,) first plane (all INT_MAX, left so) of the
// scratch, zero between calls, with tiles1 status words for launch 1 after
// launch 3's kEmitTiles; work: (2f,) int32 scratch; out: (max_out + 1,),
// -1 beyond the prefix whose length its last word holds; count, edges:
// (1,).  All int32.  The level scans fewer than 2^31 edges.
extern "C" int repro_frontier_level(const void* row_ptr, const void* col,
                                    const void* frontier, void* visited,
                                    void* first, void* state, void* work,
                                    void* out, void* count, void* edges,
                                    int f, int max_out, int tiles1,
                                    void* stream) {
  using namespace repro;
  const int ntiles1 = (f + kOffTile - 1) / kOffTile;
  if (f <= 0 || max_out <= 0 || ntiles1 > tiles1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<FrontierState*>(state);
  auto* rowend = static_cast<uint32_t*>(work);
  auto* colbase = rowend + f;
  auto* cl = static_cast<const int32_t*>(col);
  auto* vis = static_cast<int32_t*>(visited);
  auto* fst = static_cast<int32_t*>(first);
  auto* o = static_cast<int32_t*>(out);
  offsets_kernel<<<ntiles1, kThreads, 0, s>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(frontier), rowend, colbase, st,
      static_cast<int32_t*>(edges), f);
  const int g = grid_blocks();
  claim_kernel<<<g, kThreads, 0, s>>>(cl, rowend, colbase, vis, fst, st, o, f,
                                      max_out);
  emit_kernel<<<g, kThreads, 0, s>>>(cl, rowend, colbase, vis, fst, st, o,
                                     static_cast<int32_t*>(count), f,
                                     max_out);
  return static_cast<int>(cudaGetLastError());
}
