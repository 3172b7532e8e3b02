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
// One block over the claim wave's S x B lanes (S shards of the engine's
// batch; S = 1 for the chip engines, S > 1 for the mesh engines, whose
// reference records the same row and plane per shard, meshrounds.py):
//   * trace plane (scalars (C, 5), pershard (C, S, 3), count): the
//     extrema of keys[i] over the valid lanes of every shard
//     (KEY_SENTINEL / -KEY_SENTINEL when none), then thread 0 writes row
//     count % C = (count, max(pops) - min(pops), min, max, over) and
//     thread s shard s's (pops, pushes, occ), and count is bumped.  The
//     round index recorded is the plane's own count, as the engines
//     record it;
//   * span plane (hist (S, B, K, NB + 1), flows (S, F, 4), fcount (S,),
//     round (S,)): valid lane i of shard s takes sojourn s = max(round[s]
//     - births[i], 0), row = clamp(cls[i], 0, K - 1) (0 without cls) and
//     bucket = min(32 - clz(s), NB - 1) (0 for s = 0), bumps
//     hist[i][row][bucket] and raises hist[i][row][NB] to s.  The
//     histogram is lane-major, so each lane owns its slice.  Thread s
//     then writes its shard's lane 0 flow exemplar (round - s, round,
//     row, ref) at fcount[s] % F when that lane is valid, bumps
//     fcount[s], and ticks round[s].
// Either plane may be absent (null pointers).  Nothing outlives the
// launch, so a graph replay needs no reset.
//
// Latency: one round trip to memory before the barrier.  Every lane loads
// the clock, its flag, key, birth and class together (a lane's key and
// birth are read whether it is valid or not), thread 0 the cursor and the
// overflow flag, thread s its shard's words and lane 0's besides; a valid lane then updates its two
// histogram words with reductions (atomicAdd, atomicMax), which return
// nothing.  After the barrier warp 0 reduces the extrema (the keys' and
// the pops') and threads 0..S-1 only store.
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

// What thread 0 writes the trace row from besides the extrema: the
// cursor and the overflow flag, loaded at the start (in flight with the
// lanes' loads) and used after the block's barrier.
struct RowWords {
  int32_t count = 0, over = 0;
};

// What thread t < S writes shard t's rows from: its pops, pushes and
// occupancy (trace) and its flow exemplar's words, lane 0 of the shard's
// wave (span), loaded at the start like RowWords.
struct ShardWords {
  int32_t pops = 0, pushes = 0, occ = 0;
  int32_t fcount = 0, valid0 = 0, birth0 = 0, cls0 = 0, ref0 = 0, rnd = 0;
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
                      int32_t* __restrict__ round, int b, int shards,
                      int capacity, int classes, int buckets,
                      int flow_capacity) {
  __shared__ int32_t s_mn[kObsThreads / 32], s_mx[kObsThreads / 32];
  __shared__ int32_t s_pmn[kObsThreads / 32], s_pmx[kObsThreads / 32];
  const bool trace = scalars != nullptr;
  const bool span = hist != nullptr;
  const int t = threadIdx.x;
  RowWords w;
  ShardWords sw;
  if (t == 0 && trace) {
    w.count = count[0];
    w.over = over[0];
  }
  if (t < shards) {
    if (trace) {
      sw.pops = k[t];
      sw.pushes = total[t];
      sw.occ = occ[t];
    }
    if (span) {
      const int64_t l0 = static_cast<int64_t>(t) * b;
      sw.fcount = fcount[t];
      sw.valid0 = valid[l0];
      sw.birth0 = births[l0];
      sw.cls0 = cls != nullptr ? cls[l0] : 0;
      sw.ref0 = ref[l0];
      sw.rnd = round[t];
    }
  }
  const int32_t slot_count = trace ? count[0] : 0;  // one broadcast load
  int32_t mn = kKeySentinel, mx = -kKeySentinel;
  const int64_t lanes = static_cast<int64_t>(shards) * b;
  for (int64_t i = t; i < lanes; i += blockDim.x) {
    // a lane's words load with its flag, not after it: one round trip
    // before the histogram's
    const bool v = valid[i];
    const int32_t key = trace ? keys[i] : 0;
    const int32_t birth = span ? births[i] : 0;
    int32_t row = span && cls != nullptr ? cls[i] : 0;
    // the shard's clock (one broadcast load a warp while a warp stays
    // inside one shard)
    const uint32_t rnd = span ? static_cast<uint32_t>(round[i / b]) : 0u;
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
      int32_t* h = hist + (i * classes + row) * (buckets + 1);
      // reductions, not loads: nothing comes back (each lane owns its
      // slice, so the order of the updates cannot show)
      atomicAdd(h + bucket, 1);
      atomicMax(h + buckets, s);
    }
  }
  // the pops' extrema (the imbalance) reduce beside the keys'
  int32_t pmn = t < shards ? sw.pops : kKeySentinel;
  int32_t pmx = t < shards ? sw.pops : -kKeySentinel;
  if (trace) {
    warp_min_max(mn, mx);
    warp_min_max(pmn, pmx);
    if ((t & 31) == 0) {
      s_mn[t >> 5] = mn;
      s_mx[t >> 5] = mx;
      s_pmn[t >> 5] = pmn;
      s_pmx[t >> 5] = pmx;
    }
  }
  __syncthreads();
  if (trace && t < 32) {  // warp 0 reduces the warps' extrema
    const bool wv = t < (blockDim.x + 31) / 32;
    mn = wv ? s_mn[t] : kKeySentinel;
    mx = wv ? s_mx[t] : -kKeySentinel;
    pmn = wv ? s_pmn[t] : kKeySentinel;
    pmx = wv ? s_pmx[t] : -kKeySentinel;
    warp_min_max(mn, mx);
    warp_min_max(pmn, pmx);
  }
  const int64_t slot = trace ? static_cast<int64_t>(
      static_cast<uint32_t>(slot_count) % static_cast<uint32_t>(capacity)) : 0;
  if (trace && t == 0) {
    const int32_t c = w.count;
    int32_t* row = scalars + slot * 5;
    row[0] = c;
    row[1] = pmx - pmn;  // imbalance: max - min of the shards' pops
    row[2] = mn;
    row[3] = mx;
    row[4] = w.over ? 1 : 0;
    count[0] = c + 1;
  }
  if (t >= shards) return;
  if (trace) {
    int32_t* per = pershard + (slot * shards + t) * 3;
    per[0] = sw.pops;
    per[1] = sw.pushes;
    per[2] = sw.occ;
  }
  if (span) {
    const uint32_t rnd = static_cast<uint32_t>(sw.rnd);
    if (sw.valid0) {
      int32_t s = static_cast<int32_t>(rnd - static_cast<uint32_t>(sw.birth0));
      s = s > 0 ? s : 0;
      int32_t row = sw.cls0;
      row = row < 0 ? 0 : (row > classes - 1 ? classes - 1 : row);
      const int32_t f = sw.fcount;
      int32_t* e = flows + (static_cast<int64_t>(t) * flow_capacity +
                            static_cast<uint32_t>(f) %
                                static_cast<uint32_t>(flow_capacity)) * 4;
      e[0] = static_cast<int32_t>(rnd - static_cast<uint32_t>(s));
      e[1] = static_cast<int32_t>(rnd);
      e[2] = row;
      e[3] = sw.ref0;
      fcount[t] = f + 1;
    }
    round[t] = static_cast<int32_t>(rnd + 1u);
  }
}

}  // namespace repro

// S shards of b lanes each (S = 1: one chip engine's round).  keys, ref,
// births, cls: (S * b,) int32 (keys null without a trace plane; ref and
// births null without a span plane; cls null for class 0); valid:
// (S * b,) bool; k, total, occ: (S,) int32 (a round's pops, pushes and
// occupancy after it, by shard; 0-d when S = 1) and over: 0-d bool (read
// with a trace plane).  Trace plane: scalars (capacity, 5), pershard
// (capacity, S, 3), count 0-d int32, or three nulls.  Span plane: hist
// (S, b, classes, buckets + 1), flows (S, flow_capacity, 4), fcount and
// round (S,) int32 (one clock a shard), or four nulls.  b >= 1, 1 <= S <=
// kObsThreads.  Returns cudaGetLastError() after the one launch.
extern "C" int repro_obs_record(const void* keys, const void* valid,
                                const void* ref, const void* births,
                                const void* cls, const void* k,
                                const void* total, const void* occ,
                                const void* over, void* scalars,
                                void* pershard, void* count, void* hist,
                                void* flows, void* fcount, void* round,
                                int b, int shards, int capacity, int classes,
                                int buckets, int flow_capacity,
                                void* stream) {
  using namespace repro;
  if (b < 1 || shards < 1 || shards > kObsThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t lanes = static_cast<int64_t>(shards) * b;
  const int threads =
      lanes >= kObsThreads ? kObsThreads
                           : static_cast<int>((lanes + 31) / 32 * 32);
  obs_record_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const bool*>(valid),
      static_cast<const int32_t*>(ref), static_cast<const int32_t*>(births),
      static_cast<const int32_t*>(cls), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(total), static_cast<const int32_t*>(occ),
      static_cast<const bool*>(over), static_cast<int32_t*>(scalars),
      static_cast<int32_t*>(pershard), static_cast<int32_t*>(count),
      static_cast<int32_t*>(hist), static_cast<int32_t*>(flows),
      static_cast<int32_t*>(fcount), static_cast<int32_t*>(round), b,
      shards, capacity, classes, buckets, flow_capacity);
  return static_cast<int>(cudaGetLastError());
}
