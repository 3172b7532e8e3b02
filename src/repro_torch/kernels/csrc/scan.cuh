// Block-level ballot scan helpers of wavefaa.cu (compact.cu and frontier.cu
// rank in one pass with lookback.cuh instead).
//
// wavefaa.cu ranks a wave's active lanes in lane order across the whole
// wave (Lemma III.1's ticket order).  A wave is cut into blocks of
// blockDim.x lanes, one lane per thread.  Pass 1 counts each block's
// active lanes; pass 2 gives each block the sum of the counts of the
// blocks BEFORE it, so bases follow block order.  One atomicAdd per
// block would hand bases out in arrival order and break the ticket order.
#pragma once

#include <cstdint>

namespace repro {

constexpr int kBlock = 1024;  // lanes per block, one per thread

// Exclusive rank of `flag` among the block's lanes in thread order
// (__ballot_sync + __popc per warp, then a scan over the warp counts).
// Writes the block's popcount to *total.  Every thread of the block
// must call it.
__device__ __forceinline__ uint32_t block_ballot_rank(bool flag,
                                                      uint32_t* total) {
  __shared__ uint32_t warp_incl[32];
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t warp = threadIdx.x >> 5;
  const uint32_t nwarps = blockDim.x >> 5;
  const uint32_t ballot = __ballot_sync(0xffffffffu, flag);
  const uint32_t rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_incl[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    uint32_t c = lane < nwarps ? warp_incl[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= static_cast<uint32_t>(off)) c += y;
    }
    warp_incl[lane] = c;  // inclusive scan of the warp counts
  }
  __syncthreads();
  const uint32_t before = warp ? warp_incl[warp - 1] : 0u;
  *total = warp_incl[nwarps - 1];
  __syncthreads();  // warp_incl may be reused by the next call
  return before + rank;
}

// Sum of counts[0..upto), identical in every thread of the block.
__device__ __forceinline__ uint32_t block_sum(const uint32_t* counts,
                                              int upto) {
  __shared__ uint32_t partial[32];
  uint32_t s = 0;
  for (int i = threadIdx.x; i < upto; i += blockDim.x) s += counts[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31u) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < (blockDim.x >> 5) ? partial[threadIdx.x] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) partial[0] = s;
  }
  __syncthreads();
  const uint32_t r = partial[0];
  __syncthreads();  // partial may be reused by the next call
  return r;
}

// Pass 1: counts[b] = number of active lanes in block b.  The mask is a
// torch bool tensor: one byte per lane, 0 or 1.
__global__ void ballot_count_kernel(const uint8_t* __restrict__ mask,
                                    uint32_t* __restrict__ counts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool a = i < n && mask[i];
  uint32_t total;
  block_ballot_rank(a, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

}  // namespace repro
