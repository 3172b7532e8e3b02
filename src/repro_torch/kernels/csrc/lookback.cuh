// A block's exclusive scan, and the decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016) that gives a tile its base across blocks, over one 64-bit status
// word per tile: the high 32 bits say what the low 32 hold (0 nothing
// yet, 1 the tile's own count, 2 its inclusive prefix).  A tile publishes
// its count, reads its predecessors' words 32 at a time, sums counts back
// to the nearest inclusive prefix, and publishes its own.  Tiles must
// take their ids in launch order (a ticket counter), so a tile only waits
// on tiles that are already running.  The words are 8-byte aligned and each is
// written whole, so a reader sees either the old or the new word.
#pragma once

#include <cstdint>

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

constexpr unsigned long long kTileCount = 1ull << 32;
constexpr unsigned long long kTileInclusive = 2ull << 32;

// The exclusive base of `tile` whose own count is `count`.  Called by one
// whole warp; every lane gets the base.  Publishes the tile's inclusive
// prefix before it returns.
__device__ __forceinline__ uint32_t lookback_base(
    unsigned long long* status, int tile, uint32_t count) {
  volatile unsigned long long* st = status;
  const uint32_t lane = threadIdx.x & 31u;
  if (tile == 0) {
    if (lane == 0) st[0] = kTileInclusive | count;
    return 0u;
  }
  if (lane == 0) st[tile] = kTileCount | count;
  uint32_t excl = 0;
  int end = tile - 1;  // this pass reads tiles end - lane
  while (true) {
    const int idx = end - static_cast<int>(lane);
    unsigned long long w = kTileInclusive;  // before tile 0: a prefix of 0
    if (idx >= 0) w = st[idx];
    const uint32_t flag = static_cast<uint32_t>(w >> 32);
    if (__any_sync(0xffffffffu, flag == 0u)) continue;  // not yet published
    const uint32_t incl = __ballot_sync(0xffffffffu, flag == 2u);
    uint32_t v = static_cast<uint32_t>(w);
    // sum back to (and including) the nearest inclusive prefix
    if (incl && lane > static_cast<uint32_t>(__ffs(incl) - 1)) v = 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    excl += v;
    if (incl) break;
    end -= 32;
  }
  if (lane == 0) st[tile] = kTileInclusive | (excl + count);
  return excl;
}

// The inclusive prefix of `tile`, once it is published.  One thread.
__device__ __forceinline__ uint32_t wait_inclusive(
    unsigned long long* status, int tile) {
  volatile unsigned long long* st = status;
  unsigned long long w;
  while (((w = st[tile]) >> 32) != 2ull) {
  }
  return static_cast<uint32_t>(w);
}

}  // namespace repro
