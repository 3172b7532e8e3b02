// Decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016) over one 64-bit status word per
// tile: the high 32 bits say what the low 32 hold (0 nothing yet, 1 the
// tile's own count, 2 its inclusive prefix).  A tile publishes its count,
// reads its predecessors' words 32 at a time, sums counts back to the
// nearest inclusive prefix, and publishes its own.  Tiles must take their
// ids in launch order (a ticket counter), so a tile only waits on tiles
// that are already running.  The words are 8-byte aligned and each is
// written whole, so a reader sees either the old or the new word.
#pragma once

#include <cstdint>

namespace repro {

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
