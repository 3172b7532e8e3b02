// One level of queue-driven BFS for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/frontier.py:_frontier_kernel,
// which walks the frontier in one sequential loop: for each frontier
// vertex in order (-1 slots skipped) and each of its CSR neighbours in
// order, mark the neighbour visited and, if it was unvisited, write it at
// ticket = running count, clamped to max_out - 1.  Here the level runs in
// parallel and the output is the same, bit for bit:
//
//   1. An exclusive scan of the frontier slots' degrees (0 for -1) gives
//      offsets: edge p of the sequential stream belongs to the slot i
//      with offsets[i] <= p < offsets[i + 1].
//   2. One thread per edge finds its slot (binary search over offsets)
//      and its target v.  If visited[v] == 0 it does atomicMin(first[v],
//      p): first[] is an (n,) scratch plane of INT_MAX kept by the caller.
//   3. An edge is fresh iff visited[v] == 0 and first[v] == p: the first
//      occurrence of an unvisited vertex in the stream, which is the edge
//      the sequential loop finds fresh.  A block-ordered scan of the fresh
//      flags (ballot ranks per block, block bases from ONE block that
//      scans the block counts linearly) gives each its ticket r.
//   4. A fresh edge writes out[r] when r < max_out - 1, and out[max_out-1]
//      when r == count - 1 (the Pallas clamp: the last fresh vertex wins
//      the last slot).  It sets visited[v] = 1 and resets first[v] to
//      INT_MAX, so first[] is all INT_MAX again after every level with no
//      O(n) pass.  Every scanned target was visited already or has a
//      winner, so this is the Pallas kernel's visited map.
//
// Only a winner writes its vertex's visited and first words, and a
// non-winner is never fresh whatever it reads there, so steps 3 and 4
// can read visited while it changes.  Testing visited before the atomic
// keeps most of a hub vertex's edges away from its first[] word once it
// is visited.
//
// Bound: bytes.  Per level the frontier and its distinct row_ptr words
// are read, per scanned edge its col word, and per distinct target its
// visited word (once, however many edges reach it); per fresh vertex its
// visited word is written, and the -1-padded output and the count (the
// scratch traffic and the binary search are not counted).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "scan.cuh"

namespace repro {

// Exclusive sum of `x` over the block's threads in thread order; writes
// the block's total to *total.  Every thread of the block must call it.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t x,
                                                        uint32_t* total) {
  __shared__ uint32_t warp_incl[32];
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t warp = threadIdx.x >> 5;
  const uint32_t nwarps = blockDim.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= static_cast<uint32_t>(off)) incl += y;
  }
  if (lane == 31u) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t c = lane < nwarps ? warp_incl[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= static_cast<uint32_t>(off)) c += y;
    }
    warp_incl[lane] = c;
  }
  __syncthreads();
  const uint32_t before = warp ? warp_incl[warp - 1] : 0u;
  *total = warp_incl[nwarps - 1];
  __syncthreads();  // warp_incl may be reused by the next call
  return before + incl - x;
}

// counts[0..nblk) -> exclusive bases, in place, and the sum to *total.
// ONE block: each thread scans a contiguous run of counts, so the work
// is linear in the block count (scan.cuh's block_sum is quadratic).
__global__ void scan_counts_kernel(uint32_t* __restrict__ counts, int nblk,
                                   int32_t* __restrict__ total) {
  const int per = (nblk + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < nblk ? lo + per : nblk;
  uint32_t s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  uint32_t all;
  uint32_t base = block_exclusive_sum(s, &all);
  for (int i = lo; i < hi; ++i) {
    const uint32_t c = counts[i];
    counts[i] = base;
    base += c;
  }
  if (threadIdx.x == 0) *total = static_cast<int32_t>(all);
}

__device__ __forceinline__ uint32_t slot_degree(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ frontier,
    int i, int f) {
  if (i >= f) return 0u;
  const int32_t u = frontier[i];
  return u < 0 ? 0u : static_cast<uint32_t>(row_ptr[u + 1] - row_ptr[u]);
}

__global__ void degree_count_kernel(const int32_t* __restrict__ row_ptr,
                                    const int32_t* __restrict__ frontier,
                                    uint32_t* __restrict__ counts, int f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t total;
  block_exclusive_sum(slot_degree(row_ptr, frontier, i, f), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void degree_offsets_kernel(const int32_t* __restrict__ row_ptr,
                                      const int32_t* __restrict__ frontier,
                                      const uint32_t* __restrict__ bases,
                                      uint32_t* __restrict__ offsets, int f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t total;
  const uint32_t ex =
      block_exclusive_sum(slot_degree(row_ptr, frontier, i, f), &total);
  if (i < f) offsets[i] = bases[blockIdx.x] + ex;
}

// Target of stream edge p < offsets[f]: the largest slot i with
// offsets[i] <= p has offsets[i + 1] > p, so it is a live slot with p
// among its edges.
__device__ __forceinline__ int32_t edge_target(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const int32_t* __restrict__ frontier,
    const uint32_t* __restrict__ offsets, int f, uint32_t p) {
  int lo = 0, hi = f - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= p) lo = mid; else hi = mid - 1;
  }
  const int32_t u = frontier[lo];
  return col[row_ptr[u] + static_cast<int32_t>(p - offsets[lo])];
}

__global__ void claim_kernel(const int32_t* __restrict__ row_ptr,
                             const int32_t* __restrict__ col,
                             const int32_t* __restrict__ frontier,
                             const uint32_t* __restrict__ offsets,
                             const int32_t* __restrict__ visited,
                             int32_t* __restrict__ first, int f,
                             int edges) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= edges) return;
  const int32_t v = edge_target(row_ptr, col, frontier, offsets, f, p);
  if (visited[v] == 0) atomicMin(first + v, p);
}

// visited and first change during emit_kernel (winners only), so these
// are plain loads, not the read-only path.
__device__ __forceinline__ bool edge_fresh(const int32_t* visited,
                                           const int32_t* first, int32_t v,
                                           int p) {
  return visited[v] == 0 && first[v] == p;
}

__global__ void fresh_count_kernel(const int32_t* __restrict__ row_ptr,
                                   const int32_t* __restrict__ col,
                                   const int32_t* __restrict__ frontier,
                                   const uint32_t* __restrict__ offsets,
                                   const int32_t* visited,
                                   const int32_t* first,
                                   uint32_t* __restrict__ counts, int f,
                                   int edges) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool fresh = false;
  if (p < edges) {
    const int32_t v = edge_target(row_ptr, col, frontier, offsets, f, p);
    fresh = edge_fresh(visited, first, v, p);
  }
  uint32_t total;
  block_ballot_rank(fresh, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void emit_kernel(const int32_t* __restrict__ row_ptr,
                            const int32_t* __restrict__ col,
                            const int32_t* __restrict__ frontier,
                            const uint32_t* __restrict__ offsets,
                            int32_t* visited, int32_t* first,
                            const uint32_t* __restrict__ bases,
                            const int32_t* __restrict__ count,
                            int32_t* __restrict__ out, int f, int edges,
                            int max_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool fresh = false;
  int32_t v = 0;
  if (p < edges) {
    v = edge_target(row_ptr, col, frontier, offsets, f, p);
    fresh = edge_fresh(visited, first, v, p);
  }
  uint32_t block_total;
  const uint32_t r = bases[blockIdx.x] + block_ballot_rank(fresh,
                                                           &block_total);
  if (!fresh) return;
  const uint32_t last = static_cast<uint32_t>(max_out - 1);
  if (r < last)
    out[r] = v;
  else if (r == static_cast<uint32_t>(*count) - 1u)
    out[last] = v;
  visited[v] = 1;
  first[v] = INT_MAX;
}

}  // namespace repro

// Degree scan of the frontier: offsets[0..f) exclusive, offsets[f] the
// level's edge count.  row_ptr: (n+1,); frontier: (f,); dcounts: scratch
// of ceil(f/1024); offsets: (f+1,).  All int32, f > 0.
extern "C" int repro_frontier_offsets(const void* row_ptr,
                                      const void* frontier, void* dcounts,
                                      void* offsets, int f, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (f + kBlock - 1) / kBlock;
  auto* rp = static_cast<const int32_t*>(row_ptr);
  auto* fr = static_cast<const int32_t*>(frontier);
  auto* dc = static_cast<uint32_t*>(dcounts);
  auto* off = static_cast<uint32_t*>(offsets);
  degree_count_kernel<<<blocks, kBlock, 0, s>>>(rp, fr, dc, f);
  scan_counts_kernel<<<1, kBlock, 0, s>>>(dc, blocks,
                                          reinterpret_cast<int32_t*>(off + f));
  degree_offsets_kernel<<<blocks, kBlock, 0, s>>>(rp, fr, dc, off, f);
  return static_cast<int>(cudaGetLastError());
}

// The level's edges, after repro_frontier_offsets: edges = offsets[f] > 0.
// visited: (n,) updated in place; first: (n,) all INT_MAX, left so; out:
// (max_out,) pre-filled with -1; count: (1,); fcounts: scratch of
// ceil(edges/1024).
extern "C" int repro_frontier_expand(const void* row_ptr, const void* col,
                                     const void* frontier,
                                     const void* offsets, void* visited,
                                     void* first, void* out, void* count,
                                     void* fcounts, int f, int edges,
                                     int max_out, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (edges + kBlock - 1) / kBlock;
  auto* rp = static_cast<const int32_t*>(row_ptr);
  auto* cl = static_cast<const int32_t*>(col);
  auto* fr = static_cast<const int32_t*>(frontier);
  auto* off = static_cast<const uint32_t*>(offsets);
  auto* vis = static_cast<int32_t*>(visited);
  auto* fst = static_cast<int32_t*>(first);
  auto* fc = static_cast<uint32_t*>(fcounts);
  auto* cnt = static_cast<int32_t*>(count);
  claim_kernel<<<blocks, kBlock, 0, s>>>(rp, cl, fr, off, vis, fst, f, edges);
  fresh_count_kernel<<<blocks, kBlock, 0, s>>>(rp, cl, fr, off, vis, fst, fc,
                                               f, edges);
  scan_counts_kernel<<<1, kBlock, 0, s>>>(fc, blocks, cnt);
  emit_kernel<<<blocks, kBlock, 0, s>>>(rp, cl, fr, off, vis, fst, fc, cnt,
                                        static_cast<int32_t*>(out), f, edges,
                                        max_out);
  return static_cast<int>(cudaGetLastError());
}
