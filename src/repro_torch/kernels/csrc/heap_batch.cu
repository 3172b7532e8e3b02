// Batched d-ary min-heap operations for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/heap_batch.py:_heap_kernel.
// A batch of (op, key, val) is applied to the heap's key / val planes in
// batch-index order, which is the linearization order: INSERT sifts up
// (rejected when full), DELETE-MIN takes the root out and sifts the last
// node down into the hole, then scrubs the vacated slot (rejected when
// empty), any other opcode is inert.  The comparisons are the Pallas
// body's: sift-up moves while parent > key, the child scan starts at
// (KEY_INF, -1) and takes a child only when it is strictly smaller, and
// sift-down moves while best child < last.  Keys compare as signed int32.
// The Pallas loops are fixed-trip over max_depth; these end early where
// the Pallas moving flag drops and never run longer, so the planes agree
// bit for bit.
//
// The ops are serial by definition, so one thread applies them.  The
// block's other threads stage the op batch into shared memory in chunks
// (coalesced loads) and write the chunk's results back, so the serial
// thread touches device memory only for heap nodes.  The planes are
// updated in place (the Pallas kernel copies both per batch) and the size
// goes from a device scalar to a device scalar: the host reads nothing.
//
// Bound: a chain of dependent loads.  A pop reads the d children of each
// level before it knows where to go next, so a batch costs about
// ops x depth dependent loads (depth = log_d(size), about 10 on a 2^19-
// node 4-ary heap); both planes of a 2^20-slot heap (8 MB) sit in the
// 50 MB L2.  Its bytes bound counts the opcodes in (4 B per op) and the
// key and val of each INSERT lane (8 B), the results out (9 B per op),
// the size word each way, per pop the root, the last leaf and its scrub
// (24 B) and per sift-down level d child keys, the winner's val and one
// node written (4d + 12 B), and per applied insert one parent key read
// and its node written (12 B): tens of
// nanoseconds at HBM rate for the priority path's batches, far under the
// time of the dependent-load chain.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int32_t kKeyInf = 0x7fffffff;
constexpr int32_t kOpInsert = 0;
constexpr int32_t kOpDelmin = 1;
constexpr int kHeapThreads = 256;
constexpr int kChunk = 2048;  // ops staged in shared memory at a time

template <int A>
__global__ void __launch_bounds__(kHeapThreads)
heap_apply_kernel(int32_t* __restrict__ keys, int32_t* __restrict__ vals,
                  const int32_t* __restrict__ size_in,
                  const int32_t* __restrict__ ops,
                  const int32_t* __restrict__ okeys,
                  const int32_t* __restrict__ ovals,
                  int32_t* __restrict__ outk, int32_t* __restrict__ outv,
                  uint8_t* __restrict__ ok, int32_t* __restrict__ size_out,
                  int b, int cap_log2, int max_depth) {
  constexpr int D = 1 << A;
  __shared__ int32_t s_op[kChunk], s_key[kChunk], s_val[kChunk];
  __shared__ int32_t s_outk[kChunk], s_outv[kChunk];
  __shared__ uint8_t s_ok[kChunk];
  const int32_t cap = static_cast<int32_t>(1u << cap_log2);
  int32_t size = 0;
  if (threadIdx.x == 0) size = *size_in;
  for (int c0 = 0; c0 < b; c0 += kChunk) {
    const int n = b - c0 < kChunk ? b - c0 : kChunk;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      s_op[t] = ops[c0 + t];
      s_key[t] = okeys[c0 + t];
      s_val[t] = ovals[c0 + t];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int32_t op = s_op[i];
        int32_t rk = kKeyInf, rv = -1;
        uint8_t applied = 0;
        if (op == kOpInsert && size < cap) {
          // hole starts at `size`; parents move down while larger
          const int32_t key = s_key[i];
          int32_t j = size;
          for (int t = 0; t < max_depth && j > 0; ++t) {
            const int32_t p = (j - 1) >> A;
            const int32_t pk = keys[p];
            if (!(pk > key)) break;
            keys[j] = pk;
            vals[j] = vals[p];
            j = p;
          }
          keys[j] = key;
          vals[j] = s_val[i];
          ++size;
          applied = 1;
        } else if (op == kOpDelmin && size > 0) {
          // root out; the last node sifts down into the hole
          rk = keys[0];
          rv = vals[0];
          const int32_t nsize = size - 1;
          const int32_t lk = keys[nsize];
          const int32_t lv = vals[nsize];
          if (nsize > 0) {
            int32_t j = 0;
            for (int t = 0; t < max_depth; ++t) {
              const int64_t base = (static_cast<int64_t>(j) << A) + 1;
              int32_t ck[D];
#pragma unroll
              for (int c = 0; c < D; ++c)
                ck[c] = base + c < nsize ? keys[base + c] : kKeyInf;
              int32_t bk = kKeyInf, bj = -1;
#pragma unroll
              for (int c = 0; c < D; ++c) {
                if (ck[c] < bk) {
                  bk = ck[c];
                  bj = static_cast<int32_t>(base + c);
                }
              }
              if (bj < 0 || !(bk < lk)) break;
              keys[j] = bk;
              vals[j] = vals[bj];
              j = bj;
            }
            keys[j] = lk;
            vals[j] = lv;
          }
          // scrub the vacated tail slot so stale keys can't resurface
          keys[nsize] = kKeyInf;
          vals[nsize] = -1;
          size = nsize;
          applied = 1;
        }
        s_outk[i] = rk;
        s_outv[i] = rv;
        s_ok[i] = applied;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      outk[c0 + t] = s_outk[t];
      outv[c0 + t] = s_outv[t];
      ok[c0 + t] = s_ok[t];
    }
    __syncthreads();  // the next chunk overwrites the staging buffers
  }
  if (threadIdx.x == 0) *size_out = size;
}

}  // namespace repro

// keys/vals: (2^cap_log2,) int32, updated in place; size_in: (1,) int32;
// ops/okeys/ovals: (b,) int32; outk/outv: (b,) int32; ok: (b,) bool;
// size_out: (1,) int32.  b > 0, 0 < cap_log2 <= 30, arity_log2 in 1..2,
// max_depth = ceil(cap_log2 / arity_log2) + 1.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without a
// launch, for an arity it was not built for).
extern "C" int repro_heap_apply(void* keys, void* vals, const void* size_in,
                                const void* ops, const void* okeys,
                                const void* ovals, void* outk, void* outv,
                                void* ok, void* size_out, int b,
                                int cap_log2, int arity_log2, int max_depth,
                                void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<int32_t*>(keys);
  auto* v = static_cast<int32_t*>(vals);
  auto* si = static_cast<const int32_t*>(size_in);
  auto* o = static_cast<const int32_t*>(ops);
  auto* ok_ = static_cast<const int32_t*>(okeys);
  auto* ov = static_cast<const int32_t*>(ovals);
  auto* rk = static_cast<int32_t*>(outk);
  auto* rv = static_cast<int32_t*>(outv);
  auto* a = static_cast<uint8_t*>(ok);
  auto* so = static_cast<int32_t*>(size_out);
  switch (arity_log2) {
    case 1:
      heap_apply_kernel<1><<<1, kHeapThreads, 0, s>>>(
          k, v, si, o, ok_, ov, rk, rv, a, so, b, cap_log2, max_depth);
      break;
    case 2:
      heap_apply_kernel<2><<<1, kHeapThreads, 0, s>>>(
          k, v, si, o, ok_, ov, rk, rv, a, so, b, cap_log2, max_depth);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
