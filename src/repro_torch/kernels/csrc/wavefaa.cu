// WAVEFAA ticket ballot for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/wavefaa.py:_wavefaa_kernel.
// Active lane i of an (N,) mask gets counter + (active lanes before i),
// inactive lanes get -1, and new_counter = counter + popcount.
//
// The TPU kernel carried the running count in SMEM across a sequential
// grid.  Hopper runs blocks in parallel and in no order, so a wave is cut
// into tiles of kTileLanes = 8,192 lanes (1,024 threads, 8 lanes each)
// and ranked in ONE launch:
//   * a wave of one tile (every wave of the round engine's road path:
//     batch x fanout = 4,096 lanes) is one block: a block scan of the
//     threads' popcounts gives each lane its rank, and the counter is
//     the base;
//   * a wider wave takes its tiles by ticket and finds each tile's base
//     with a decoupled look-back over the tiles before it (lookback.cuh),
//     as compact.cu does: the tile id, not the arrival order, decides the
//     lanes a block ranks, so tickets follow lane order.  The last tile
//     writes the new counter, and the block that finishes last leaves
//     the scratch (status words, ticket and done counters) zero for the
//     next call.
// Arithmetic is uint32, so a counter near 2^31 wraps exactly as the
// reference's int32 does.  The counter stays on the card.
//
// Bound: bytes, 1 B of mask in and 4 B of ticket out per lane: 4,096
// lanes are 20 KB, 6.1 ns at 3.35 TB/s.  At the round engine's widths the
// launch is the cost, so one launch (the two-pass scan it replaces took
// two) is what the design buys.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace repro {

constexpr int kFaaThreads = 1024;
constexpr int kFaaLanesPerThread = 8;
constexpr int kFaaTileLanes = kFaaThreads * kFaaLanesPerThread;

// Scratch of a wave of several tiles: int32 words {ticket, done, 0, 0},
// then one uint64 status word per tile, all zero between calls.
struct FaaScratch {
  unsigned int ticket;
  unsigned int done;
  unsigned int pad[2];
  unsigned long long status[1];
};

__global__ void __launch_bounds__(kFaaThreads)
    wavefaa_kernel(const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ counter,
                   int32_t* __restrict__ tickets,
                   int32_t* __restrict__ new_counter,
                   FaaScratch* __restrict__ scratch, int n, int ntiles) {
  __shared__ uint32_t s_tile, s_base;
  int tile = 0;
  if (ntiles > 1) {
    if (threadIdx.x == 0) s_tile = atomicAdd(&scratch->ticket, 1u);
    __syncthreads();
    tile = static_cast<int>(s_tile);
  }
  // this thread's 8 lanes, as bits of `bits`
  const int64_t i0 = static_cast<int64_t>(tile) * kFaaTileLanes +
                     static_cast<int64_t>(threadIdx.x) * kFaaLanesPerThread;
  uint32_t bits = 0;
  if (i0 + kFaaLanesPerThread <= n &&
      (reinterpret_cast<uintptr_t>(mask + i0) & 7u) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(mask + i0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits |= (((w.x >> (8 * j)) & 0xffu) != 0u) << j;
      bits |= (((w.y >> (8 * j)) & 0xffu) != 0u) << (j + 4);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kFaaLanesPerThread; ++j)
      if (i0 + j < n && mask[i0 + j]) bits |= 1u << j;
  }
  uint32_t tile_count;
  const uint32_t before = block_exclusive_sum(__popc(bits), &tile_count);
  uint32_t base = static_cast<uint32_t>(counter[0]);
  if (ntiles > 1) {
    if (threadIdx.x < 32) {
      const uint32_t b = lookback_base(scratch->status, tile, tile_count);
      if (threadIdx.x == 0) s_base = b;
    }
    __syncthreads();
    base += s_base;
  }
  uint32_t rank = base + before;
  int32_t t[kFaaLanesPerThread];
#pragma unroll
  for (int j = 0; j < kFaaLanesPerThread; ++j) {
    const bool a = (bits >> j) & 1u;
    t[j] = a ? static_cast<int32_t>(rank) : -1;
    rank += a;
  }
  if (i0 + kFaaLanesPerThread <= n &&
      (reinterpret_cast<uintptr_t>(tickets + i0) & 15u) == 0) {
    reinterpret_cast<int4*>(tickets + i0)[0] = make_int4(t[0], t[1], t[2],
                                                         t[3]);
    reinterpret_cast<int4*>(tickets + i0)[1] = make_int4(t[4], t[5], t[6],
                                                         t[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kFaaLanesPerThread; ++j)
      if (i0 + j < n) tickets[i0 + j] = t[j];
  }
  if (tile == ntiles - 1 && threadIdx.x == 0)
    new_counter[0] = static_cast<int32_t>(base + tile_count);
  if (ntiles == 1) return;

  // the block that finishes last leaves the scratch zero for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_tile = atomicAdd(&scratch->done, 1u);
  }
  __syncthreads();
  if (s_tile == static_cast<uint32_t>(ntiles - 1)) {
    for (int u = threadIdx.x; u < ntiles; u += kFaaThreads)
      scratch->status[u] = 0ull;
    if (threadIdx.x == 0) {
      scratch->ticket = 0u;
      scratch->done = 0u;
    }
  }
}

}  // namespace repro

// mask: (n,) bool; counter, new_counter: (1,) int32; tickets: (n,) int32;
// scratch: for n > 8,192 lanes 4 + 2 * ceil(n / 8192) int32 words, 8-byte
// aligned and zero before the first call (every call leaves it zero);
// unused (may be null) for n <= 8,192.  n > 0.  Returns cudaGetLastError()
// after the one launch.
extern "C" int repro_wavefaa(const void* mask, const void* counter,
                             void* tickets, void* new_counter, void* scratch,
                             int n, void* stream) {
  using namespace repro;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (n + kFaaTileLanes - 1) / kFaaTileLanes;
  if (ntiles > 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // a one-tile wave runs only the threads its lanes need (whole warps)
  const int threads =
      ntiles > 1 ? kFaaThreads
                 : ((n + kFaaLanesPerThread - 1) / kFaaLanesPerThread + 31) /
                       32 * 32;
  wavefaa_kernel<<<ntiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(counter),
      static_cast<int32_t*>(tickets), static_cast<int32_t*>(new_counter),
      static_cast<FaaScratch*>(scratch), n, ntiles);
  return static_cast<int>(cudaGetLastError());
}
