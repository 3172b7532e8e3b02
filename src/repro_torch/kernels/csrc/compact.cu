// Dense-wave compaction for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/compact.py:_compact_kernel.
// Each of k value planes (k, n) has its active lanes (bool mask) packed
// into a dense (k, width) prefix in lane order; ranks >= width drop, the
// tail of every dense plane is zero, and count is the TRUE popcount
// (it may exceed width: the engine folds it into its overflow check).
//
// One launch, a single pass with decoupled look-back (lookback.cuh).  A
// tile is kTileLanes = 8,192 lanes, 8 per thread.  Each block takes its
// tile id from a ticket counter, so it only ever waits on tiles that are
// already running, and the tile id (not the arrival order) decides which
// lanes it ranks: ranks follow lane order across the wave.  The block
// counts its active lanes, publishes that count, finds its exclusive base
// by looking back over its predecessors' status words, publishes its
// inclusive prefix, and scatters.  The last tile's inclusive prefix is the
// true popcount: that tile writes count, and the last kTailTiles tiles
// (by id) wait for it and zero the dense tail [min(total, width), width)
// between them, a share each.  The block that finishes last resets the
// scratch (status words, ticket and done counters) to zero, so no memset
// runs between calls; concurrent calls need their own scratch.
//
// Bound: bytes.  The mask and the active lanes' planes are read once and
// the dense planes written once; on the engine's kron wave (1.26 M lanes,
// bool mask, one plane, width 2^17) that is about 1.8 MB, 0.534 us at
// 3.35 TB/s.  Measured there (chip_smoke.py phase 7, NVIDIA H100 80GB
// HBM3, 700.00 W): 8.56 us, against 14.40 us for torch.cumsum of the
// mask; launch latency and the look-back chain, not bandwidth.  The
// two-pass kernel this replaces (a count pass, then a pass in which
// every block summed every count before it) took 17.24 us.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace repro {

constexpr int kCompactThreads = 1024;
constexpr int kLanesPerThread = 8;
constexpr int kTileLanes = kCompactThreads * kLanesPerThread;
// Tiles that share the zeroing of the dense tail.  They wait on the last
// tile, which is always scheduled: fewer than kTailTiles blocks ever wait
// on a later tile, and the card holds far more blocks than that.
constexpr int kTailTiles = 32;

// Scratch: int32 words {ticket, done, 0, 0}, then one uint64 status word
// per tile, all zero between calls.
struct CompactScratch {
  unsigned int ticket;
  unsigned int done;
  unsigned int pad[2];
  unsigned long long status[1];
};

// Exclusive scan of v over the block's threads in thread order; writes
// the block's total to *total.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* total) {
  __shared__ uint32_t warp_incl[32];
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= static_cast<uint32_t>(off)) x += y;
  }
  if (lane == 31) warp_incl[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t c = warp_incl[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= static_cast<uint32_t>(off)) c += y;
    }
    warp_incl[lane] = c;
  }
  __syncthreads();
  *total = warp_incl[31];
  return (warp ? warp_incl[warp - 1] : 0u) + x - v;
}

__global__ void __launch_bounds__(kCompactThreads)
    compact_lookback_kernel(const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ planes,
                            int32_t* __restrict__ dense,
                            int32_t* __restrict__ count,
                            CompactScratch* __restrict__ scratch, int n,
                            int nplanes, int width, int ntiles) {
  __shared__ uint32_t s_tile, s_base, s_total;
  if (threadIdx.x == 0) s_tile = atomicAdd(&scratch->ticket, 1u);
  __syncthreads();
  const int tile = static_cast<int>(s_tile);

  // this thread's 8 lanes, as bits of `bits`
  const int64_t i0 = static_cast<int64_t>(tile) * kTileLanes +
                     static_cast<int64_t>(threadIdx.x) * kLanesPerThread;
  uint32_t bits = 0;
  if (i0 + kLanesPerThread <= n &&
      (reinterpret_cast<uintptr_t>(mask + i0) & 7u) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(mask + i0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits |= (((w.x >> (8 * j)) & 0xffu) != 0u) << j;
      bits |= (((w.y >> (8 * j)) & 0xffu) != 0u) << (j + 4);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j)
      if (i0 + j < n && mask[i0 + j]) bits |= 1u << j;
  }
  uint32_t tile_count;
  const uint32_t before = block_exclusive_scan(__popc(bits), &tile_count);

  if (threadIdx.x < 32) {
    const uint32_t base = lookback_base(scratch->status, tile, tile_count);
    if (threadIdx.x == 0) s_base = base;
  }
  __syncthreads();
  const uint32_t base = s_base;
  uint32_t rank = base + before;
  for (int j = 0; j < kLanesPerThread; ++j) {
    if (!((bits >> j) & 1u)) continue;
    if (rank < static_cast<uint32_t>(width)) {
      for (int p = 0; p < nplanes; ++p)
        dense[static_cast<int64_t>(p) * width + rank] =
            planes[static_cast<int64_t>(p) * n + i0 + j];
    }
    ++rank;
  }

  // the last kTailTiles tiles zero the dense tail, once the last tile
  // has published the total
  const int helpers = ntiles < kTailTiles ? ntiles : kTailTiles;
  const int share = tile - (ntiles - helpers);
  if (share >= 0) {
    if (threadIdx.x == 0) {
      const uint32_t total =
          tile == ntiles - 1 ? base + tile_count
                             : wait_inclusive(scratch->status, ntiles - 1);
      s_total = total;
      if (tile == ntiles - 1) count[0] = static_cast<int32_t>(total);
    }
    __syncthreads();
    const int64_t filled =
        s_total < static_cast<uint32_t>(width) ? s_total : width;
    const int64_t span = width - filled;
    const int64_t lo = filled + span * share / helpers;
    const int64_t hi = filled + span * (share + 1) / helpers;
    for (int p = 0; p < nplanes; ++p) {
      int32_t* d = dense + static_cast<int64_t>(p) * width;
      for (int64_t q = lo + threadIdx.x; q < hi; q += kCompactThreads)
        d[q] = 0;
    }
  }

  // the block that finishes last leaves the scratch zero for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_tile = atomicAdd(&scratch->done, 1u);
  }
  __syncthreads();
  if (s_tile == static_cast<uint32_t>(ntiles - 1)) {
    for (int t = threadIdx.x; t < ntiles; t += kCompactThreads)
      scratch->status[t] = 0ull;
    if (threadIdx.x == 0) {
      scratch->ticket = 0u;
      scratch->done = 0u;
    }
  }
}

}  // namespace repro

// mask: (n,) bool; planes: (nplanes, n) int32; dense: (nplanes, width)
// int32; count: (1,) int32; scratch: 4 + 2 * ceil(n / 8192) int32 words,
// 8-byte aligned, zero before the first call (every call leaves it zero).
// n > 0, width > 0.  Returns cudaGetLastError() after the one launch.
extern "C" int repro_wave_compact(const void* mask, const void* planes,
                                  void* dense, void* count, void* scratch,
                                  int n, int nplanes, int width,
                                  void* stream) {
  using namespace repro;
  if (n <= 0 || width <= 0 || nplanes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (n + kTileLanes - 1) / kTileLanes;
  compact_lookback_kernel<<<ntiles, kCompactThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(planes),
      static_cast<int32_t*>(dense), static_cast<int32_t*>(count),
      static_cast<CompactScratch*>(scratch), n, nplanes, width, ntiles);
  return static_cast<int>(cudaGetLastError());
}
