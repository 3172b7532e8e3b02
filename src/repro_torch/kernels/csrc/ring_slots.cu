// G-LFQ ring waves (paper Alg. 1 TRYENQ / TRYDEQ fast path) for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels src/repro/kernels/ring_slots.py:_enq_kernel
// and :_deq_kernel.  The ring is four int32 planes of 2n = 1 << s slots
// (cycle, safe, enq, idx).  Active tickets in one wave hit pairwise
// distinct slots (Lemma III.1: a wave spans fewer than 2n tickets), so a
// wave is one thread per lane with no atomics: gather the lane's slot,
// test, and write it back if the lane succeeds.  Inactive and failing
// lanes write nothing, which is what the reference's out-of-range "drop"
// scatter does.
//
// The planes are updated IN PLACE.  The Pallas kernel copies all four
// (2n,) planes per wave; in place a wave costs O(B) and not O(2n), which
// on a 2^24-slot ring is 256 MB of traffic per wave avoided.  Bound:
// 25 bytes per dequeue lane and 37 per installing enqueue lane, so at
// B = 1024..4096 lanes the launch latency dominates.
//
// Two faces of each wave:
//   * ring_dequeue_kernel / ring_enqueue_kernel take the tickets from the
//     caller (-1 = inactive), one thread per lane over as many blocks as
//     the wave needs;
//   * ring_dequeue_wave_kernel / ring_enqueue_wave_kernel are a ring
//     round's whole queue side, each in ONE launch: the dequeue wave
//     computes k = live ? min(tail - head, batch) : 0, consumes tickets
//     head + [0, k) and advances head in place; the enqueue wave ranks
//     the spawn mask (ballot mode, B1's in-block scan) or takes the
//     compacted wave's count (dense mode), decides overflow for the whole
//     wave, installs tickets tail + rank unless it overflows, and advances
//     tail in place.  In a round of the device loop these two launches
//     replace about twenty small elementwise kernels whose only work was
//     this ticket arithmetic; at these widths every launch costs a few
//     microseconds of latency and the bytes cost nanoseconds.
//
// Each wave kernel is ONE block that loops over its lanes.  Every lane
// needs head (or tail) before the new value is written, and no lane may
// install before overflow is known, which needs the whole wave's count:
// one block orders both with __syncthreads and keeps no counter between
// launches, so a graph replay needs no reset.  A block of 1,024 threads
// covers 1,024 dequeue lanes or 8,192 ballot lanes a pass, which is every
// wave of the round engine's road path in one pass; wider waves take more
// passes on the one block (a last-block-done ticket would spread them over
// the card, at the price of a kept counter that each launch must leave
// zero).
//
// Tickets are unsigned mod-2^32 counters carried in int32: the cycle is a
// logical shift, and cycle/ticket comparisons take the wraparound
// difference in uint32 and read its sign as int32 (no signed overflow).
// The wave kernels know which lanes are active from the round's own
// arithmetic (lane < k, the ballot bit), so tickets past 2^31 are
// consumed and installed like any other.
//
// Birth stamps (the span layer; ring_slots.py: enq_planes(birth_round=),
// deq_planes(birth_packed=True)): each wave kernel has a packed instance.
// The enqueue wave writes the flag (round << 1) | 1, round read from a
// device word (the span plane's clock, so a graph replay reads the
// round's own), instead of 1; the dequeue wave tests the flag's low bit
// and writes each consumed lane's stamp enq >> 1 (-1 on a miss).  The
// stamp rides the flag word the waves already read and write: no extra
// plane, one extra int a dequeue lane out.  The flag stays positive for
// rounds below 2^30, which the engine core enforces.  The unpacked
// instances are the ones above, unchanged.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kWaveThreads = 1024;
constexpr int kWaveLanesPerThread = 8;  // ballot lanes: B1's tile layout
constexpr int kWaveTileLanes = kWaveThreads * kWaveLanesPerThread;

// Wrap-safe a < b on cycles (ring_slots.py:cycle_lt): the difference is
// shifted back into ticket space and read as a signed 32-bit value.
__device__ __forceinline__ bool cycle_lt(int32_t a, int32_t b, int s) {
  return static_cast<int32_t>((static_cast<uint32_t>(b) -
                               static_cast<uint32_t>(a)) << s) > 0;
}

// TRYDEQ of one active lane: consume on a cycle match (the value goes to
// *v), advance a stale empty slot to the ticket's cycle, mark a stale live
// slot unsafe.  Returns whether the lane consumed.  kPacked: the flag is
// the enq word's low bit, and a consume writes the stamp (its high bits)
// to *birth.
template <bool kPacked = false>
__device__ __forceinline__ bool try_dequeue(int32_t* __restrict__ cyc,
                                            int32_t* __restrict__ saf,
                                            const int32_t* __restrict__ enq,
                                            int32_t* __restrict__ idx,
                                            uint32_t t, int s,
                                            int32_t idx_bot, int32_t* v,
                                            int32_t* birth = nullptr) {
  const uint32_t j = t & ((1u << s) - 1u);
  const int32_t c = static_cast<int32_t>(t >> s);
  const int32_t e_c = cyc[j], e_e = enq[j], e_i = idx[j];
  const bool empty = e_i == idx_bot || e_i == idx_bot - 1;
  const bool flag = kPacked ? (e_e & 1) == 1 : e_e == 1;
  const bool hit = e_c == c && !empty && flag;
  if (hit) {
    idx[j] = idx_bot - 1;  // consume: index := bottom_c
    *v = e_i;
    if constexpr (kPacked) *birth = e_e >> 1;
  } else if (cycle_lt(e_c, c, s)) {
    if (empty) cyc[j] = c;   // advance a stale empty slot
    else saf[j] = 0;         // mark a stale live slot unsafe
  }
  return hit;
}

// TRYENQ of one active lane in two steps: gather the ticket's slot, then
// install where the slot's cycle is behind the ticket's, the slot is
// empty, and the slot is safe or head <= ticket, with the enq word `flag`
// (1, or a packed birth stamp).  A thread with several lanes gathers all
// their slots before it installs any: the lanes' slots are pairwise
// distinct (Lemma III.1), so the gathers overlap in flight and no install
// can change another lane's slot.
struct EnqSlot {
  int32_t c, s, i;
};

__device__ __forceinline__ EnqSlot enq_gather(const int32_t* __restrict__ cyc,
                                              const int32_t* __restrict__ saf,
                                              const int32_t* __restrict__ idx,
                                              uint32_t t, int s) {
  const uint32_t j = t & ((1u << s) - 1u);
  return {cyc[j], saf[j], idx[j]};
}

__device__ __forceinline__ bool enq_install(int32_t* __restrict__ cyc,
                                            int32_t* __restrict__ saf,
                                            int32_t* __restrict__ enq,
                                            int32_t* __restrict__ idx,
                                            EnqSlot e, uint32_t t,
                                            int32_t value, uint32_t head,
                                            int s, int32_t idx_bot,
                                            int32_t flag = 1) {
  const uint32_t j = t & ((1u << s) - 1u);
  const int32_t c = static_cast<int32_t>(t >> s);
  const bool empty = e.i == idx_bot || e.i == idx_bot - 1;
  const bool past_head = static_cast<int32_t>(t - head) >= 0;
  const bool can = cycle_lt(e.c, c, s) && empty && (e.s == 1 || past_head);
  if (can) {
    cyc[j] = c;
    saf[j] = 1;
    enq[j] = flag;
    idx[j] = value;
  }
  return can;
}

__device__ __forceinline__ bool try_enqueue(int32_t* __restrict__ cyc,
                                            int32_t* __restrict__ saf,
                                            int32_t* __restrict__ enq,
                                            int32_t* __restrict__ idx,
                                            uint32_t t, int32_t value,
                                            uint32_t head, int s,
                                            int32_t idx_bot,
                                            int32_t flag = 1) {
  return enq_install(cyc, saf, enq, idx, enq_gather(cyc, saf, idx, t, s), t,
                     value, head, s, idx_bot, flag);
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
  if (t >= 0)
    hit = try_dequeue(cyc, saf, enq, idx, static_cast<uint32_t>(t), s,
                      idx_bot, &v);
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
  if (t >= 0)
    can = try_enqueue(cyc, saf, enq, idx, static_cast<uint32_t>(t),
                      values[i], static_cast<uint32_t>(head[0]), s, idx_bot);
  ok[i] = can;
}

// A round's dequeue side (fusedrounds.py: RingEngine._round before the
// step): k = live ? min(tail - head, batch) : 0 in int32 arithmetic, lane
// i < k consumes ticket head + i, and head += k in place.  One block.
// kPacked: births[i] gets lane i's stamp (-1 on a miss).
template <bool kPacked>
__global__ void __launch_bounds__(kWaveThreads)
    ring_dequeue_wave_kernel(int32_t* __restrict__ cyc,
                             int32_t* __restrict__ saf,
                             const int32_t* __restrict__ enq,
                             int32_t* __restrict__ idx,
                             int32_t* __restrict__ head,
                             const int32_t* __restrict__ tail,
                             const bool* __restrict__ live,
                             int32_t* __restrict__ vals,
                             bool* __restrict__ ok,
                             int32_t* __restrict__ k_out,
                             int32_t* __restrict__ births, int batch, int s,
                             int32_t idx_bot) {
  __shared__ uint32_t s_head;
  __shared__ int32_t s_k;
  if (threadIdx.x == 0) {
    const uint32_t h = static_cast<uint32_t>(head[0]);
    const int32_t occ =
        static_cast<int32_t>(static_cast<uint32_t>(tail[0]) - h);
    s_head = h;
    s_k = live[0] ? min(occ, batch) : 0;
  }
  __syncthreads();
  const uint32_t h = s_head;
  const int32_t k = s_k;
  for (int i = threadIdx.x; i < batch; i += blockDim.x) {
    int32_t v = -1, birth = -1;
    bool hit = false;
    if (i < k)
      hit = try_dequeue<kPacked>(cyc, saf, enq, idx,
                                 h + static_cast<uint32_t>(i), s, idx_bot,
                                 &v, &birth);
    vals[i] = v;
    ok[i] = hit;
    if constexpr (kPacked) births[i] = birth;
  }
  // only thread 0 read head from memory, so it may write it back now
  if (threadIdx.x == 0) {
    head[0] = static_cast<int32_t>(h + static_cast<uint32_t>(k));
    k_out[0] = k;
  }
}

// The ballot bits of this thread's 8 lanes of `tile` (bit j = lane
// tile * 8,192 + threadIdx.x * 8 + j), as B1 (wavefaa.cu) reads them.
__device__ __forceinline__ uint32_t ballot_bits(const uint8_t* __restrict__ m,
                                                int tile, int n) {
  const int64_t i0 = static_cast<int64_t>(tile) * kWaveTileLanes +
                     static_cast<int64_t>(threadIdx.x) * kWaveLanesPerThread;
  uint32_t bits = 0;
  if (i0 + kWaveLanesPerThread <= n &&
      (reinterpret_cast<uintptr_t>(m + i0) & 7u) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(m + i0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits |= (((w.x >> (8 * j)) & 0xffu) != 0u) << j;
      bits |= (((w.y >> (8 * j)) & 0xffu) != 0u) << (j + 4);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWaveLanesPerThread; ++j)
      if (i0 + j < n && m[i0 + j]) bits |= 1u << j;
  }
  return bits;
}

// A round's enqueue side (fusedrounds.py: RingEngine._round after the
// step).  Ballot mode (mask != null): n_child = the popcount of live &
// mask, lane i's ticket tail + (its rank among the set lanes), in lane
// order.  Dense mode (mask == null; the wave compacted by B3): n_child =
// live ? count : 0, lane i < n_child's ticket tail + i.  Both: over =
// int32(tail + n_child - head) > capacity; unless over every ticket is
// installed (TRYENQ) and tail += n_child in place; total = over ? 0 :
// n_child.  kPacked: the enq flag installed is (*birth_round << 1) | 1.
// One block.
template <bool kBallot, bool kPacked>
__global__ void __launch_bounds__(kWaveThreads)
    ring_enqueue_wave_kernel(int32_t* __restrict__ cyc,
                             int32_t* __restrict__ saf,
                             int32_t* __restrict__ enq,
                             int32_t* __restrict__ idx,
                             const int32_t* __restrict__ head,
                             int32_t* __restrict__ tail,
                             const bool* __restrict__ live,
                             const int32_t* __restrict__ values,
                             const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ count,
                             const int32_t* __restrict__ birth_round,
                             int32_t* __restrict__ total_out,
                             bool* __restrict__ over_out, int n, int capacity,
                             int s, int32_t idx_bot) {
  __shared__ uint32_t s_head, s_tail, s_count;
  __shared__ int32_t s_flag;
  __shared__ bool s_live;
  if (threadIdx.x == 0) {
    s_head = static_cast<uint32_t>(head[0]);
    s_tail = static_cast<uint32_t>(tail[0]);
    s_live = live[0];
    if (!kBallot) s_count = s_live ? static_cast<uint32_t>(count[0]) : 0u;
    if (kPacked)
      s_flag = static_cast<int32_t>(
          (static_cast<uint32_t>(birth_round[0]) << 1) | 1u);
  }
  __syncthreads();
  const uint32_t h = s_head, t0 = s_tail;
  const int32_t flag = kPacked ? s_flag : 1;
  const int ntiles = (n + kWaveTileLanes - 1) / kWaveTileLanes;
  uint32_t n_child, bits0 = 0, before0 = 0;
  if (kBallot) {
    // pass 1: the wave's popcount; a one-tile wave keeps its bits and
    // its ranks, which are this scan's
    uint32_t mine = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const uint32_t b = s_live ? ballot_bits(mask, tile, n) : 0u;
      if (tile == 0) bits0 = b;
      mine += __popc(b);
    }
    before0 = block_exclusive_sum(mine, &n_child);
  } else {
    n_child = s_count;
  }
  const bool over =
      static_cast<int32_t>(t0 + n_child - h) > static_cast<int32_t>(capacity);
  if (!over && n_child != 0u) {
    if (kBallot) {
      // pass 2: rank tile by tile in lane order and install
      uint32_t base = t0;
      for (int tile = 0; tile < ntiles; ++tile) {
        uint32_t b = bits0, tile_count = n_child, rank = base + before0;
        if (ntiles > 1) {
          b = ballot_bits(mask, tile, n);
          rank = base + block_exclusive_sum(__popc(b), &tile_count);
        }
        const int64_t i0 =
            static_cast<int64_t>(tile) * kWaveTileLanes +
            static_cast<int64_t>(threadIdx.x) * kWaveLanesPerThread;
        // every gather of this thread's lanes, then every install
        EnqSlot e[kWaveLanesPerThread] = {};
        uint32_t tk[kWaveLanesPerThread];
        int32_t v[kWaveLanesPerThread] = {};
#pragma unroll
        for (int j = 0; j < kWaveLanesPerThread; ++j) {
          tk[j] = rank;
          if ((b >> j) & 1u) {
            v[j] = values[i0 + j];
            e[j] = enq_gather(cyc, saf, idx, rank++, s);
          }
        }
#pragma unroll
        for (int j = 0; j < kWaveLanesPerThread; ++j)
          if ((b >> j) & 1u)
            enq_install(cyc, saf, enq, idx, e[j], tk[j], v[j], h, s,
                        idx_bot, flag);
        base += tile_count;
      }
    } else {
      const int lanes =
          static_cast<int>(min(n_child, static_cast<uint32_t>(n)));
      for (int i = threadIdx.x; i < lanes; i += blockDim.x)
        try_enqueue(cyc, saf, enq, idx, t0 + static_cast<uint32_t>(i),
                    values[i], h, s, idx_bot, flag);
    }
  }
  // only thread 0 read tail from memory, so it may write it back now
  if (threadIdx.x == 0) {
    tail[0] = static_cast<int32_t>(over ? t0 : t0 + n_child);
    total_out[0] = over ? 0 : static_cast<int32_t>(n_child);
    over_out[0] = over;
  }
}

// Threads of a one-block wave kernel for `lanes` lanes a thread's worth
// each: whole warps, at least one, at most kWaveThreads.
inline int wave_threads(int64_t threads) {
  const int64_t w = (threads + 31) / 32 * 32;
  return static_cast<int>(w < 32 ? 32 : (w > kWaveThreads ? kWaveThreads : w));
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

// Planes: four (1 << s,) int32; head (updated in place), tail, k: 0-d
// int32; live: 0-d bool; vals: (batch,) int32; ok: (batch,) bool; births:
// (batch,) int32 for the packed instance, or null for the unpacked one.
// batch >= 0.  Returns cudaGetLastError() after the one launch.
extern "C" int repro_ring_dequeue_wave(void* cyc, void* saf, const void* enq,
                                       void* idx, void* head,
                                       const void* tail, const void* live,
                                       void* vals, void* ok, void* k,
                                       void* births, int batch, int s,
                                       int idx_bot, void* stream) {
  using namespace repro;
  if (batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = births != nullptr ? ring_dequeue_wave_kernel<true>
                                   : ring_dequeue_wave_kernel<false>;
  kernel<<<1, wave_threads(batch), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<const int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(head), static_cast<const int32_t*>(tail),
      static_cast<const bool*>(live), static_cast<int32_t*>(vals),
      static_cast<bool*>(ok), static_cast<int32_t*>(k),
      static_cast<int32_t*>(births), batch, s, idx_bot);
  return static_cast<int>(cudaGetLastError());
}

// Planes: four (1 << s,) int32; head, total: 0-d int32; tail: 0-d int32,
// updated in place; live, over: 0-d bool; values: (n,) int32.  Ballot
// mode: mask (n,) bool and count null.  Dense mode: mask null and count a
// 0-d int32 (the compacted wave's true popcount).  birth_round: a 0-d
// int32 for the packed instance, or null for the unpacked one.  n >= 0.
// Returns cudaGetLastError() after the one launch.
extern "C" int repro_ring_enqueue_wave(void* cyc, void* saf, void* enq,
                                       void* idx, const void* head,
                                       void* tail, const void* live,
                                       const void* values, const void* mask,
                                       const void* count,
                                       const void* birth_round, void* total,
                                       void* over, int n, int capacity,
                                       int s, int idx_bot, void* stream) {
  using namespace repro;
  if (n < 0 || (mask == nullptr) == (count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // a ballot wave of one tile runs only the threads its lanes need
  const bool ballot = mask != nullptr;
  const int threads =
      !ballot ? wave_threads(n)
      : n > kWaveTileLanes
          ? kWaveThreads
          : wave_threads((static_cast<int64_t>(n) + kWaveLanesPerThread - 1) /
                         kWaveLanesPerThread);
  const bool packed = birth_round != nullptr;
  auto* kernel = ballot ? (packed ? ring_enqueue_wave_kernel<true, true>
                                  : ring_enqueue_wave_kernel<true, false>)
                        : (packed ? ring_enqueue_wave_kernel<false, true>
                                  : ring_enqueue_wave_kernel<false, false>);
  kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<const int32_t*>(head), static_cast<int32_t*>(tail),
      static_cast<const bool*>(live), static_cast<const int32_t*>(values),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(birth_round), static_cast<int32_t*>(total),
      static_cast<bool*>(over), n, capacity, s, idx_bot);
  return static_cast<int>(cudaGetLastError());
}
