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
// would hand out slots in arrival order.  So the ranks come from three
// passes in block order (the pattern of scan.cuh, one count per expert):
//   1. expert_count_kernel: each block of 1024 pairs counts its pairs per
//      expert into counts[block][e] (shared-memory atomics: a count does
//      not depend on order);
//   2. expert_base_kernel: one block turns counts into exclusive bases
//      over blocks, one warp per expert at a time;
//   3. expert_rank_kernel: each pair's rank inside its block, in order:
//      __match_any_sync on the id gives a warp's peers, the popcount of
//      the peers on lower lanes the rank inside the warp, and a
//      (warps x E) table in shared memory, scanned over warps per expert,
//      the rank across the block's warps.
//
// Bound: bytes, 4 B of id in and 4 B of slot out per pair (8 N); the
// (blocks x E) counts are a few KB.  At the prefill shape (N = 65,536)
// that is 0.16 us, far below the three launches' latency.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int kPairs = 1024;     // pairs per block, one per thread
constexpr int kMaxExperts = 64;  // size of the per-block expert tables
constexpr int kWarps = kPairs / 32;

__global__ void expert_count_kernel(const int32_t* __restrict__ ids,
                                    int32_t* __restrict__ counts, int n,
                                    int num_experts) {
  __shared__ int32_t cnt[kMaxExperts];
  if (threadIdx.x < num_experts) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * kPairs + threadIdx.x;
  const int e = i < n ? ids[i] : -1;
  if (e >= 0 && e < num_experts) atomicAdd(&cnt[e], 1);
  __syncthreads();
  if (threadIdx.x < num_experts)
    counts[blockIdx.x * num_experts + threadIdx.x] = cnt[threadIdx.x];
}

// counts[b][e] -> sum of counts[b'][e] over b' < b, for every expert.
__global__ void expert_base_kernel(int32_t* __restrict__ counts, int blocks,
                                   int num_experts) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int e = warp; e < num_experts; e += blockDim.x >> 5) {
    int32_t carry = 0;
    for (int b0 = 0; b0 < blocks; b0 += 32) {
      const int b = b0 + lane;
      const int32_t c = b < blocks ? counts[b * num_experts + e] : 0;
      int32_t incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (b < blocks) counts[b * num_experts + e] = carry + incl - c;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

__global__ void expert_rank_kernel(const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ bases,
                                   int32_t* __restrict__ slots, int n,
                                   int num_experts, int capacity) {
  __shared__ int32_t table[kWarps][kMaxExperts];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWarps * kMaxExperts; j += kPairs)
    (&table[0][0])[j] = 0;
  __syncthreads();
  const int i = blockIdx.x * kPairs + threadIdx.x;
  const int e = i < n ? ids[i] : -1;
  const bool routed = e >= 0 && e < num_experts;
  // every unrouted lane shares the key -1; their ranks are not used
  const unsigned peers = __match_any_sync(0xffffffffu, routed ? e : -1);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (routed && rank == 0) table[warp][e] = __popc(peers);
  __syncthreads();
  if (threadIdx.x < num_experts) {  // exclusive scan over warps, per expert
    int32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = table[w][threadIdx.x];
      table[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  if (i >= n) return;
  int32_t slot;
  if (e < 0) {
    slot = -1;
  } else if (!routed) {
    slot = capacity > 0 ? 0 : -1;
  } else {
    slot = bases[blockIdx.x * num_experts + e] + table[warp][e] + rank;
    if (slot >= capacity) slot = -1;
  }
  slots[i] = slot;
}

}  // namespace repro

// ids, slots: (n,) int32; counts: scratch of ceil(n/1024) * num_experts
// int32.  n > 0, 1 <= num_experts <= 64, capacity >= 0.  Returns
// cudaGetLastError() after the three launches.
extern "C" int repro_expert_tickets(const void* ids, void* slots,
                                    void* counts, int n, int num_experts,
                                    int capacity, void* stream) {
  using namespace repro;
  if (n <= 0 || num_experts < 1 || num_experts > kMaxExperts ||
      capacity < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kPairs - 1) / kPairs;
  const int32_t* in = static_cast<const int32_t*>(ids);
  int32_t* cnt = static_cast<int32_t*>(counts);
  expert_count_kernel<<<blocks, kPairs, 0, s>>>(in, cnt, n, num_experts);
  expert_base_kernel<<<1, kPairs, 0, s>>>(cnt, blocks, num_experts);
  expert_rank_kernel<<<blocks, kPairs, 0, s>>>(
      in, cnt, static_cast<int32_t*>(slots), n, num_experts, capacity);
  return static_cast<int>(cudaGetLastError());
}
