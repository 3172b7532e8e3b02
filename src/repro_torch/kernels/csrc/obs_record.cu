// One round's observability record for Hopper (sm_90a): the trace row and
// the span histogram of a fused round engine, in one launch.
//
// Not a Pallas kernel.  It replaces what the reference's fused_loop does
// in XLA after each round (src/repro/runtime/enginecore.py: fused_loop,
// trace_record; src/repro/obs/trace.py: masked_min_max, trace_record;
// src/repro/obs/spans.py: span_record, span_tick), which XLA fuses into
// the round.  Written as torch ops (obs/record.py: obs_record_plain) the
// same work is some twenty 0-d kernels a round, each a node of the
// captured round at about 1.5 us; here it is one node.
//
// One block over the claim wave's B lanes (the engine's batch):
//   * trace plane (scalars (C, 5), pershard (C, 1, 3), count): the
//     extrema of keys[i] over the valid lanes (KEY_SENTINEL / -KEY_SENTINEL
//     when none), then thread 0 writes row count % C = (count, 0, min,
//     max, over) and (k, total, occ), and bumps count.  The round index
//     recorded is the plane's own count, as the engines record it;
//   * span plane (hist (B, K, NB + 1), flows (F, 4), fcount, round):
//     valid lane i takes sojourn s = max(round - births[i], 0), row =
//     clamp(cls[i], 0, K - 1) (0 without cls) and bucket = min(32 -
//     clz(s), NB - 1) (0 for s = 0), bumps hist[i][row][bucket] and raises
//     hist[i][row][NB] to s.  The histogram is lane-major, so each lane
//     owns its slice: no atomics.  Thread 0 then writes lane 0's flow
//     exemplar (round - s, round, row, ref[0]) at fcount % F when lane 0
//     is valid, bumps fcount, and ticks round.
// Either plane may be absent (null pointers).  Nothing outlives the
// launch, so a graph replay needs no reset.
//
// Latency: one round trip to memory before the barrier.  Every lane loads
// the clock, its flag, key, birth and class together (a lane's key and
// birth are read whether it is valid or not), thread 0 the cursors, the
// round's words and lane 0's besides; a valid lane then updates its two
// histogram words with reductions (atomicAdd, atomicMax), which return
// nothing.  After the barrier warp 0 reduces the extrema and thread 0
// only stores.
//
// Bound: valid a lane, and a valid lane's key and birth in and two
// histogram words read and written, plus a 32-byte row and a few words:
// tens of nanoseconds at HBM rate.  A launch costs microseconds, so it is
// launch-bound, and one launch is the point.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int kObsThreads = 1024;
constexpr int32_t kKeySentinel = 0x7fffffff;

// Lane 0 of the warp gets the warp's least mn and greatest mx.
__device__ __forceinline__ void warp_min_max(int32_t& mn, int32_t& mx) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int32_t a = __shfl_down_sync(0xffffffffu, mn, d);
    const int32_t c = __shfl_down_sync(0xffffffffu, mx, d);
    mn = a < mn ? a : mn;
    mx = c > mx ? c : mx;
  }
}

// What thread 0 writes the rows from besides the extrema: the cursors,
// the round's words and lane 0's, loaded by thread 0 at the start (all in
// flight together) and used after the block's barrier.
struct RowWords {
  int32_t count = 0, fcount = 0, k = 0, total = 0, occ = 0, over = 0;
  int32_t valid0 = 0, birth0 = 0, cls0 = 0, ref0 = 0;
};

__global__ void __launch_bounds__(kObsThreads)
    obs_record_kernel(const int32_t* __restrict__ keys,
                      const bool* __restrict__ valid,
                      const int32_t* __restrict__ ref,
                      const int32_t* __restrict__ births,
                      const int32_t* __restrict__ cls,
                      const int32_t* __restrict__ k,
                      const int32_t* __restrict__ total,
                      const int32_t* __restrict__ occ,
                      const bool* __restrict__ over,
                      int32_t* __restrict__ scalars,
                      int32_t* __restrict__ pershard,
                      int32_t* __restrict__ count,
                      int32_t* __restrict__ hist,
                      int32_t* __restrict__ flows,
                      int32_t* __restrict__ fcount,
                      int32_t* __restrict__ round, int b, int capacity,
                      int classes, int buckets, int flow_capacity) {
  __shared__ int32_t s_mn[kObsThreads / 32], s_mx[kObsThreads / 32];
  const bool trace = scalars != nullptr;
  const bool span = hist != nullptr;
  RowWords w;
  if (threadIdx.x == 0) {
    if (trace) {
      w.count = count[0];
      w.k = k[0];
      w.total = total[0];
      w.occ = occ[0];
      w.over = over[0];
    }
    if (span) {
      w.fcount = fcount[0];
      w.valid0 = valid[0];
      w.birth0 = births[0];
      w.cls0 = cls != nullptr ? cls[0] : 0;
      w.ref0 = ref[0];
    }
  }
  // every thread reads the clock itself (one broadcast load a warp)
  const uint32_t rnd = span ? static_cast<uint32_t>(round[0]) : 0u;
  int32_t mn = kKeySentinel, mx = -kKeySentinel;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    // a lane's words load with its flag, not after it: one round trip
    // before the histogram's
    const bool v = valid[i];
    const int32_t key = trace ? keys[i] : 0;
    const int32_t birth = span ? births[i] : 0;
    int32_t row = span && cls != nullptr ? cls[i] : 0;
    if (!v) continue;
    if (trace) {
      mn = key < mn ? key : mn;
      mx = key > mx ? key : mx;
    }
    if (span) {
      int32_t s = static_cast<int32_t>(rnd - static_cast<uint32_t>(birth));
      s = s > 0 ? s : 0;
      row = row < 0 ? 0 : (row > classes - 1 ? classes - 1 : row);
      int bucket = s > 0 ? 32 - __clz(s) : 0;
      bucket = bucket < buckets - 1 ? bucket : buckets - 1;
      int32_t* h = hist + (static_cast<int64_t>(i) * classes + row) *
                              (buckets + 1);
      // reductions, not loads: nothing comes back (each lane owns its
      // slice, so the order of the updates cannot show)
      atomicAdd(h + bucket, 1);
      atomicMax(h + buckets, s);
    }
  }
  if (trace) {
    warp_min_max(mn, mx);
    if ((threadIdx.x & 31) == 0) {
      s_mn[threadIdx.x >> 5] = mn;
      s_mx[threadIdx.x >> 5] = mx;
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  if (trace) {  // warp 0 reduces the warps' extrema
    const bool w = threadIdx.x < (blockDim.x + 31) / 32;
    mn = w ? s_mn[threadIdx.x] : kKeySentinel;
    mx = w ? s_mx[threadIdx.x] : -kKeySentinel;
    warp_min_max(mn, mx);
  }
  if (threadIdx.x != 0) return;
  if (trace) {
    const int32_t c = w.count;
    const int64_t slot = static_cast<int64_t>(
        static_cast<uint32_t>(c) % static_cast<uint32_t>(capacity));
    int32_t* row = scalars + slot * 5;
    row[0] = c;
    row[1] = 0;  // imbalance: max - min of one shard's pops
    row[2] = mn;
    row[3] = mx;
    row[4] = w.over ? 1 : 0;
    int32_t* per = pershard + slot * 3;
    per[0] = w.k;
    per[1] = w.total;
    per[2] = w.occ;
    count[0] = c + 1;
  }
  if (span) {
    if (w.valid0) {
      int32_t s = static_cast<int32_t>(
          rnd - static_cast<uint32_t>(w.birth0));
      s = s > 0 ? s : 0;
      int32_t row = w.cls0;
      row = row < 0 ? 0 : (row > classes - 1 ? classes - 1 : row);
      const int32_t f = w.fcount;
      int32_t* e = flows + static_cast<int64_t>(
                               static_cast<uint32_t>(f) %
                               static_cast<uint32_t>(flow_capacity)) * 4;
      e[0] = static_cast<int32_t>(rnd - static_cast<uint32_t>(s));
      e[1] = static_cast<int32_t>(rnd);
      e[2] = row;
      e[3] = w.ref0;
      fcount[0] = f + 1;
    }
    round[0] = static_cast<int32_t>(rnd + 1u);
  }
}

}  // namespace repro

// keys, ref, births, cls: (b,) int32 (keys null without a trace plane;
// ref and births null without a span plane; cls null for class 0);
// valid: (b,) bool; k, total, occ: 0-d int32 and over: 0-d bool (the
// round's claims, installs, occupancy after it and overflow flag; read
// with a trace plane).  Trace plane: scalars (capacity, 5), pershard
// (capacity, 1, 3), count 0-d int32, or three nulls.  Span plane: hist
// (b, classes, buckets + 1), flows (flow_capacity, 4), fcount and round
// 0-d int32, or four nulls.  b >= 1.  Returns cudaGetLastError() after
// the one launch.
extern "C" int repro_obs_record(const void* keys, const void* valid,
                                const void* ref, const void* births,
                                const void* cls, const void* k,
                                const void* total, const void* occ,
                                const void* over, void* scalars,
                                void* pershard, void* count, void* hist,
                                void* flows, void* fcount, void* round,
                                int b, int capacity, int classes,
                                int buckets, int flow_capacity,
                                void* stream) {
  using namespace repro;
  if (b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads =
      b >= kObsThreads ? kObsThreads : (b + 31) / 32 * 32;
  obs_record_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const bool*>(valid),
      static_cast<const int32_t*>(ref), static_cast<const int32_t*>(births),
      static_cast<const int32_t*>(cls), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(total), static_cast<const int32_t*>(occ),
      static_cast<const bool*>(over), static_cast<int32_t*>(scalars),
      static_cast<int32_t*>(pershard), static_cast<int32_t*>(count),
      static_cast<int32_t*>(hist), static_cast<int32_t*>(flows),
      static_cast<int32_t*>(fcount), static_cast<int32_t*>(round), b,
      capacity, classes, buckets, flow_capacity);
  return static_cast<int>(cudaGetLastError());
}
