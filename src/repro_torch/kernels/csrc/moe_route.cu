// Per-expert ticket reservation for capacity-bounded MoE dispatch, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/moe_route.py:_route_kernel.
// Pair i of an (N,) array of expert ids gets its rank among the earlier
// pairs routed to the same expert (pair order = token-major, choice-minor),
// or -1 when it is inactive (id < 0) or its rank is >= capacity.  A
// dropped pair still counts toward its expert.  An id >= E matches no
// expert, as the Pallas one-hot does: it counts toward none and gets slot
// 0 (or -1 when capacity is 0).
//
// The TPU kernel walked 128-pair tiles in grid order and carried a
// per-expert base from tile to tile in VMEM.  Hopper runs blocks in no
// order, and an atomicAdd per pair (or per block) on a per-expert counter
// would hand out slots in arrival order.  So one launch ranks tiles of
// up to 1,024 pairs, one pair per thread:
//   * in a warp, __match_any_sync on the id gives each pair its peers,
//     and the popcount of the peers on lower lanes its rank there;
//   * across the tile's warps, one warp walks the warps in order and
//     hands each warp's peer groups (distinct experts, so no two lanes of
//     a step touch one counter) their base from a per-expert counter
//     array of E ints in dynamic shared memory, which then holds the
//     tile's count per expert;
//   * a decode step (N <= 1,024: 32 pairs in the serve cell) is one
//     tile, one block, and needs nothing else: no scratch, nothing
//     allocated;
//   * a wider call (the prefill's 65,536 pairs) takes its tiles by
//     ticket and finds each tile's per-expert base with a decoupled
//     look-back over E-wide rows of 64-bit status words (flag | count,
//     the scheme of lookback.cuh, one chain per expert, walked by the
//     thread that owns the expert): the tile id, not the arrival order,
//     decides the pairs a block ranks.  The block that finishes last
//     leaves the kept scratch zero for the next call.
// E is bounded only by the two E-int tables in shared memory (counts and
// bases): up to kMaxExperts.
//
// Bound: bytes, 4 B of id in and 4 B of slot out per pair (8 N); the
// look-back's status rows (ntiles x E x 8 B) stay in L2.  At the prefill
// shape (N = 65,536) that is 0.16 us, at a decode step's 32 pairs 0.08
// ns: the launch is the cost, so the design aims at one launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int kPairs = 1024;  // pairs per tile, one per thread
constexpr int kWarpsMax = kPairs / 32;
constexpr int kMaxExperts = 24576;
constexpr unsigned long long kRowCount = 1ull << 32;
constexpr unsigned long long kRowInclusive = 2ull << 32;

// Scratch of a call of several tiles: int32 words {ticket, done, 0, 0},
// then ntiles x E uint64 status words, all zero between calls.
struct TicketScratch {
  unsigned int ticket;
  unsigned int done;
  unsigned int pad[2];
  unsigned long long status[1];
};

__global__ void __launch_bounds__(kPairs)
    expert_tickets_kernel(const int32_t* __restrict__ ids,
                          int32_t* __restrict__ slots,
                          TicketScratch* __restrict__ scratch, int n,
                          int num_experts, int capacity, int ntiles) {
  extern __shared__ int32_t smem[];
  int32_t* cnt = smem;                 // E: counts, in warp order
  int32_t* base = smem + num_experts;  // E: the tile's per-expert base
  __shared__ int32_t s_e[kWarpsMax][32], s_c[kWarpsMax][32];
  __shared__ uint32_t s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int tile = 0;
  if (ntiles > 1) {
    if (threadIdx.x == 0) s_tile = atomicAdd(&scratch->ticket, 1u);
  }
  for (int e = threadIdx.x; e < num_experts; e += blockDim.x) cnt[e] = 0;
  __syncthreads();
  if (ntiles > 1) tile = static_cast<int>(s_tile);

  const int i = tile * kPairs + threadIdx.x;
  const int e = i < n ? ids[i] : -1;
  const bool routed = e >= 0 && e < num_experts;
  // every unrouted lane shares the key -1; their ranks are not used
  const unsigned peers = __match_any_sync(0xffffffffu, routed ? e : -1);
  const int leader = __ffs(peers) - 1;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const bool lead = routed && lane == leader;
  s_e[warp][lane] = lead ? e : -1;
  s_c[warp][lane] = lead ? __popc(peers) : 0;
  __syncthreads();
  if (warp == 0) {
    // the warps' groups in warp order; a step's leaders hold distinct
    // experts, so each counter is read and written by one lane a step
    for (int w = 0; w < nwarps; ++w) {
      const int ee = s_e[w][lane];
      if (ee >= 0) {
        const int32_t b = cnt[ee];
        cnt[ee] = b + s_c[w][lane];
        s_c[w][lane] = b;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  if (ntiles > 1) {
    // publish this tile's count of every expert, then look back over the
    // tiles before it, one chain per expert
    volatile unsigned long long* row =
        scratch->status + static_cast<int64_t>(tile) * num_experts;
    for (int x = threadIdx.x; x < num_experts; x += blockDim.x) {
      const uint32_t c = static_cast<uint32_t>(cnt[x]);
      row[x] = (tile == 0 ? kRowInclusive : kRowCount) | c;
    }
    for (int x = threadIdx.x; x < num_experts; x += blockDim.x) {
      uint32_t excl = 0;
      for (int t = tile - 1; t >= 0; --t) {
        volatile unsigned long long* w =
            scratch->status + static_cast<int64_t>(t) * num_experts + x;
        unsigned long long v;
        while (((v = *w) >> 32) == 0ull) {
        }
        excl += static_cast<uint32_t>(v);
        if ((v >> 32) == 2ull) break;
      }
      if (tile > 0)
        row[x] = kRowInclusive | (excl + static_cast<uint32_t>(cnt[x]));
      base[x] = static_cast<int32_t>(excl);
    }
    __syncthreads();
  }

  if (i < n) {
    int32_t slot;
    if (e < 0) {
      slot = -1;
    } else if (!routed) {
      slot = capacity > 0 ? 0 : -1;
    } else {
      slot = s_c[warp][leader] + rank + (ntiles > 1 ? base[e] : 0);
      if (slot >= capacity) slot = -1;
    }
    slots[i] = slot;
  }
  if (ntiles == 1) return;

  // the block that finishes last leaves the scratch zero for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_tile = atomicAdd(&scratch->done, 1u);
  }
  __syncthreads();
  if (s_tile == static_cast<uint32_t>(ntiles - 1)) {
    const int64_t words = static_cast<int64_t>(ntiles) * num_experts;
    for (int64_t u = threadIdx.x; u < words; u += blockDim.x)
      scratch->status[u] = 0ull;
    if (threadIdx.x == 0) {
      scratch->ticket = 0u;
      scratch->done = 0u;
    }
  }
}

}  // namespace repro

// ids, slots: (n,) int32; scratch: for n > 1,024 pairs 4 + 2 *
// ceil(n / 1024) * num_experts int32 words, 8-byte aligned and zero before
// the first call (every call leaves it zero); unused (may be null) for
// n <= 1,024.  n > 0, 1 <= num_experts <= 24,576, capacity >= 0.  Returns
// cudaGetLastError() after the one launch.
extern "C" int repro_expert_tickets(const void* ids, void* slots,
                                    void* scratch, int n, int num_experts,
                                    int capacity, void* stream) {
  using namespace repro;
  if (n <= 0 || num_experts < 1 || num_experts > kMaxExperts ||
      capacity < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (n + kPairs - 1) / kPairs;
  if (ntiles > 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * num_experts * static_cast<int>(sizeof(int32_t));
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        expert_tickets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  // one tile runs only the threads its pairs need (whole warps)
  const int threads = ntiles > 1 ? kPairs : (n + 31) / 32 * 32;
  expert_tickets_kernel<<<ntiles, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(slots),
      static_cast<TicketScratch*>(scratch), n, num_experts, capacity,
      ntiles);
  return static_cast<int>(cudaGetLastError());
}
