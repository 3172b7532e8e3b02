// WAVEFAA ticket ballot for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/wavefaa.py:_wavefaa_kernel.
// Active lane i of an (N,) mask gets counter + (active lanes before i),
// inactive lanes get -1, and new_counter = counter + popcount.
//
// The TPU kernel carried the running count in SMEM across a sequential
// grid.  Hopper runs blocks in parallel and in no order, so the count
// becomes two passes (scan.cuh): ballot_count_kernel writes each block's
// popcount, wavefaa_tickets_kernel sums the counts of the blocks before
// its own (block order, not arrival order) and ranks its lanes with
// __ballot_sync + __popc.  Arithmetic is uint32, so a counter near 2^31
// wraps exactly as the reference's int32 does.
//
// Bound: a few bytes per lane (mask in, ticket out).  At the round
// engine's widths (a few thousand lanes) the launch latency of the two
// passes dominates the bytes by far.
#include <cuda_runtime.h>

#include "scan.cuh"

namespace repro {

__global__ void wavefaa_tickets_kernel(const uint8_t* __restrict__ mask,
                                       const uint32_t* __restrict__ counts,
                                       const int32_t* __restrict__ counter,
                                       int32_t* __restrict__ tickets,
                                       int32_t* __restrict__ new_counter,
                                       int n) {
  const uint32_t base =
      static_cast<uint32_t>(counter[0]) + block_sum(counts, blockIdx.x);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool a = i < n && mask[i];
  uint32_t total;
  const uint32_t rank = block_ballot_rank(a, &total);
  if (i < n) tickets[i] = a ? static_cast<int32_t>(base + rank) : -1;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    new_counter[0] = static_cast<int32_t>(base + total);
}

}  // namespace repro

// mask: (n,) bool; counter, new_counter: (1,) int32; tickets: (n,) int32;
// counts: scratch of ceil(n/1024) uint32.  n > 0.  Returns
// cudaGetLastError() after both launches.
extern "C" int repro_wavefaa(const void* mask, const void* counter,
                             void* tickets, void* new_counter, void* counts,
                             int n, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kBlock - 1) / kBlock;
  ballot_count_kernel<<<blocks, kBlock, 0, s>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint32_t*>(counts), n);
  wavefaa_tickets_kernel<<<blocks, kBlock, 0, s>>>(
      static_cast<const uint8_t*>(mask), static_cast<const uint32_t*>(counts),
      static_cast<const int32_t*>(counter), static_cast<int32_t*>(tickets),
      static_cast<int32_t*>(new_counter), n);
  return static_cast<int>(cudaGetLastError());
}
