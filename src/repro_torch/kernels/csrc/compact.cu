// Dense-wave compaction for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/compact.py:_compact_kernel.
// Each of k value planes (k, n) has its active lanes (bool mask) packed
// into a dense (k, width) prefix in lane order; ranks >= width drop, the
// tail of every dense plane is zero, and count is the TRUE popcount
// (it may exceed width: the engine folds it into its overflow check).
//
// Same two-pass ordered scan as wavefaa.cu (scan.cuh): block bases are
// the sums of the counts of the blocks before each block, so ranks
// follow lane order across the wave.  Every block also sums all counts
// to find the total, then zeroes its grid-stride share of the dense
// tail [min(total, width), width), so no lane is written twice.
//
// Bound: bytes.  The mask and each plane are read once and the dense
// prefix written once; on the engine's kron wave (1.26 M lanes, bool
// mask, one plane) that is about 6.3 MB in and 0.5 MB out.
#include <cuda_runtime.h>

#include "scan.cuh"

namespace repro {

__global__ void compact_scatter_kernel(const uint8_t* __restrict__ mask,
                                       const int32_t* __restrict__ planes,
                                       const uint32_t* __restrict__ counts,
                                       int32_t* __restrict__ dense,
                                       int32_t* __restrict__ count,
                                       int n, int nplanes, int width) {
  const uint32_t base = block_sum(counts, blockIdx.x);
  const uint32_t total = block_sum(counts, gridDim.x);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool a = i < n && mask[i];
  uint32_t block_total;
  const uint32_t rank = base + block_ballot_rank(a, &block_total);
  if (a && rank < static_cast<uint32_t>(width)) {
    for (int p = 0; p < nplanes; ++p)
      dense[static_cast<int64_t>(p) * width + rank] =
          planes[static_cast<int64_t>(p) * n + i];
  }
  const int filled = total < static_cast<uint32_t>(width)
                         ? static_cast<int>(total) : width;
  for (int q = filled + i; q < width; q += gridDim.x * blockDim.x) {
    for (int p = 0; p < nplanes; ++p)
      dense[static_cast<int64_t>(p) * width + q] = 0;
  }
  if (i == 0) count[0] = static_cast<int32_t>(total);
}

}  // namespace repro

// mask: (n,) bool; planes: (nplanes, n) int32; dense: (nplanes, width)
// int32; count: (1,) int32; counts: scratch of ceil(n/1024) uint32.
// n > 0, width > 0.  Returns cudaGetLastError() after both launches.
extern "C" int repro_wave_compact(const void* mask, const void* planes,
                                  void* dense, void* count, void* counts,
                                  int n, int nplanes, int width,
                                  void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kBlock - 1) / kBlock;
  ballot_count_kernel<<<blocks, kBlock, 0, s>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint32_t*>(counts), n);
  compact_scatter_kernel<<<blocks, kBlock, 0, s>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(planes),
      static_cast<const uint32_t*>(counts), static_cast<int32_t*>(dense),
      static_cast<int32_t*>(count), n, nplanes, width);
  return static_cast<int>(cudaGetLastError());
}
