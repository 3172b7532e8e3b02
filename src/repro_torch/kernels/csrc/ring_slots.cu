// G-LFQ ring waves (paper Alg. 1 TRYENQ / TRYDEQ fast path) for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels src/repro/kernels/ring_slots.py:_enq_kernel
// and :_deq_kernel.  The ring is four int32 planes of 2n = 1 << s slots
// (cycle, safe, enq, idx).  Active tickets in one wave hit pairwise
// distinct slots (Lemma III.1: a wave spans fewer than 2n tickets), so a
// wave is one thread per lane with no atomics: gather the lane's slot,
// test, and write it back if the lane succeeds.  Inactive (ticket < 0)
// and failing lanes write nothing, which is what the reference's
// out-of-range "drop" scatter does.
//
// The planes are updated IN PLACE.  The Pallas kernel copies all four
// (2n,) planes per wave; in place a wave costs O(B) and not O(2n), which
// on a 2^24-slot ring is 256 MB of traffic per wave avoided.  Bound:
// 25 bytes per dequeue lane and 37 per installing enqueue lane, so at
// B = 1024..4096 lanes the launch latency dominates.
//
// Tickets are unsigned mod-2^32 counters carried in int32: the cycle is a
// logical shift, and cycle/ticket comparisons take the wraparound
// difference in uint32 and read its sign as int32 (no signed overflow).
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int kThreads = 256;

// Wrap-safe a < b on cycles (ring_slots.py:cycle_lt): the difference is
// shifted back into ticket space and read as a signed 32-bit value.
__device__ __forceinline__ bool cycle_lt(int32_t a, int32_t b, int s) {
  return static_cast<int32_t>((static_cast<uint32_t>(b) -
                               static_cast<uint32_t>(a)) << s) > 0;
}

__global__ void ring_dequeue_kernel(int32_t* __restrict__ cyc,
                                    int32_t* __restrict__ saf,
                                    const int32_t* __restrict__ enq,
                                    int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ tickets,
                                    int32_t* __restrict__ vals,
                                    bool* __restrict__ ok, int b, int s,
                                    int32_t idx_bot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int32_t t = tickets[i];
  int32_t v = -1;
  bool hit = false;
  if (t >= 0) {
    const uint32_t j = static_cast<uint32_t>(t) & ((1u << s) - 1u);
    const int32_t c = static_cast<int32_t>(static_cast<uint32_t>(t) >> s);
    const int32_t e_c = cyc[j], e_e = enq[j], e_i = idx[j];
    const bool empty = e_i == idx_bot || e_i == idx_bot - 1;
    hit = e_c == c && !empty && e_e == 1;
    if (hit) {
      idx[j] = idx_bot - 1;  // consume: index := bottom_c
      v = e_i;
    } else if (cycle_lt(e_c, c, s)) {
      if (empty) cyc[j] = c;   // advance a stale empty slot
      else saf[j] = 0;         // mark a stale live slot unsafe
    }
  }
  vals[i] = v;
  ok[i] = hit;
}

__global__ void ring_enqueue_kernel(int32_t* __restrict__ cyc,
                                    int32_t* __restrict__ saf,
                                    int32_t* __restrict__ enq,
                                    int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ tickets,
                                    const int32_t* __restrict__ values,
                                    const int32_t* __restrict__ head,
                                    bool* __restrict__ ok, int b, int s,
                                    int32_t idx_bot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int32_t t = tickets[i];
  bool can = false;
  if (t >= 0) {
    const uint32_t j = static_cast<uint32_t>(t) & ((1u << s) - 1u);
    const int32_t c = static_cast<int32_t>(static_cast<uint32_t>(t) >> s);
    const int32_t e_c = cyc[j], e_s = saf[j], e_i = idx[j];
    const bool empty = e_i == idx_bot || e_i == idx_bot - 1;
    const bool past_head = static_cast<int32_t>(
        static_cast<uint32_t>(t) - static_cast<uint32_t>(head[0])) >= 0;
    can = cycle_lt(e_c, c, s) && empty && (e_s == 1 || past_head);
    if (can) {
      cyc[j] = c;
      saf[j] = 1;
      enq[j] = 1;
      idx[j] = values[i];
    }
  }
  ok[i] = can;
}

}  // namespace repro

// Planes: four (1 << s,) int32; tickets, vals: (b,) int32; ok: (b,) bool.
// b > 0.  Returns cudaGetLastError() after the launch.
extern "C" int repro_ring_dequeue(void* cyc, void* saf, const void* enq,
                                  void* idx, const void* tickets, void* vals,
                                  void* ok, int b, int s, int idx_bot,
                                  void* stream) {
  const int blocks = (b + repro::kThreads - 1) / repro::kThreads;
  repro::ring_dequeue_kernel<<<blocks, repro::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<const int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<const int32_t*>(tickets), static_cast<int32_t*>(vals),
      static_cast<bool*>(ok), b, s, idx_bot);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus values: (b,) int32 and head: (1,) int32.
extern "C" int repro_ring_enqueue(void* cyc, void* saf, void* enq, void* idx,
                                  const void* tickets, const void* values,
                                  const void* head, void* ok, int b, int s,
                                  int idx_bot, void* stream) {
  const int blocks = (b + repro::kThreads - 1) / repro::kThreads;
  repro::ring_enqueue_kernel<<<blocks, repro::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<const int32_t*>(tickets),
      static_cast<const int32_t*>(values),
      static_cast<const int32_t*>(head), static_cast<bool*>(ok), b, s,
      idx_bot);
  return static_cast<int>(cudaGetLastError());
}
