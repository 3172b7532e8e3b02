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
//     caller (-1 = inactive, or an explicit active mask), one thread per
//     lane over as many blocks as the wave needs;
//   * ring_dequeue_wave_kernel / ring_enqueue_wave_kernel are a round's
//     whole queue side, each in ONE launch, over an S x batch lane grid
//     whose rows are the mesh's shards (meshrounds.py; reference
//     core/distqueue.py); the single ring's round (fusedrounds.py:
//     RingEngine) is the grid at S = 1.  The dequeue wave computes the
//     round's claim (k = live ? min(occupancy, S * batch) : 0 and its
//     split over the rows), consumes those tickets and advances head in
//     place; the enqueue wave ranks the spawn mask (ballot mode, B1's
//     in-block scan) or takes the rows' compacted counts (dense mode),
//     decides overflow for the whole round, installs every child unless
//     it overflows, and advances tail in place.  In a round of the device
//     loop these two launches replace about twenty small elementwise
//     kernels whose only work was this ticket arithmetic; at these widths
//     every launch costs a few microseconds of latency and the bytes cost
//     nanoseconds.
//
// Each wave kernel is ONE block that loops over its lanes.  Every lane
// needs head (or tail) and the round's schedule before any new value is
// written, and no lane may install before overflow is known, which needs
// the whole round's count: one block orders both with __syncthreads and
// keeps no counter between launches, so a graph replay needs no reset.  A
// block of 1,024 threads covers 1,024 dequeue lanes or 8,192 ballot lanes
// a pass, which is every wave of the road path in one pass; wider waves
// take more passes on the one block (a last-block-done ticket would
// spread them over the card, at the price of a kept counter that each
// launch must leave zero).
//
// Tickets are unsigned mod-2^32 counters carried in int32: the cycle is a
// logical shift, and cycle/ticket comparisons take the wraparound
// difference in uint32 and read its sign as int32 (no signed overflow).
// The wave kernels know which lanes are active from the round's own
// arithmetic (the claim's split, the ballot bit), so tickets past 2^31
// are consumed and installed like any other.
//
// Birth stamps (the span layer; ring_slots.py: enq_planes(birth_round=),
// deq_planes(birth_packed=True)): each wave kernel has a packed instance
// on the replicated ring.  The enqueue wave writes the flag (round << 1)
// | 1, round read from a device word (the span plane's clock, so a graph
// replay reads the round's own), instead of 1; the dequeue wave tests the
// flag's low bit and writes each consumed lane's stamp enq >> 1 (-1 on a
// miss).  The stamp rides the flag word the waves already read and
// write: no extra plane, one extra int a dequeue lane out.  The flag
// stays positive for rounds below 2^30, which the engine core enforces.
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

// active: null (a lane is active iff its ticket is >= 0) or (b,) bool,
// the lane's activity whatever its ticket's sign (the functional faces'
// explicit mask: tickets past 2^31 are live there).
__global__ void ring_dequeue_kernel(int32_t* __restrict__ cyc,
                                    int32_t* __restrict__ saf,
                                    const int32_t* __restrict__ enq,
                                    int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ tickets,
                                    const bool* __restrict__ active,
                                    int32_t* __restrict__ vals,
                                    bool* __restrict__ ok, int b, int s,
                                    int32_t idx_bot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int32_t t = tickets[i];
  int32_t v = -1;
  bool hit = false;
  if (active != nullptr ? active[i] : t >= 0)
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
                                    const bool* __restrict__ active,
                                    const int32_t* __restrict__ values,
                                    const int32_t* __restrict__ head,
                                    bool* __restrict__ ok, int b, int s,
                                    int32_t idx_bot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int32_t t = tickets[i];
  bool can = false;
  if (active != nullptr ? active[i] : t >= 0)
    can = try_enqueue(cyc, saf, enq, idx, static_cast<uint32_t>(t),
                      values[i], static_cast<uint32_t>(head[0]), s, idx_bot);
  ok[i] = can;
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

// The round's waves over the lane grid.  The reference's mesh runs one
// shard per device and gathers a round's requests with one psum; here the
// shard axis is the leading dimension of an S x batch (dequeue) or S x n
// (enqueue) lane grid, and the grid is ONE block, for the reason above:
// every lane needs the round's schedule (the split of the claim, the
// ranks and the overflow test of the publish) before any lane may touch
// the planes.  Two layouts:
//   * replicated (kSharded = false): one ring of 1 << s slots, head and
//     tail 0-d; the single ring is this layout at S = 1;
//   * sharded (kSharded = true): S rings of 1 << s slots each, row r at
//     planes + (r << s), heads and tails (S,); or, with ring >= 0 (the
//     mesh across processes, one ring a rank), ring `ring` alone at
//     planes, beside all S heads and tails: the schedule, the ranks and
//     the overflow test stay the whole grid's, only that ring's lanes
//     consume or install, and every head or tail advances.
// The schedule lives in dynamic shared memory, three (dequeue) or four
// (enqueue) ints a shard, which bounds S at kMaxShards.  Birth stamps ride the replicated ring only.

constexpr int kMaxShards = 1024;

// A round's dequeue side, one launch (fusedrounds.py: RingEngine._round
// at S = 1; distqueue.py: dist_claim_round with claim_schedule,
// dist_sharded_claim_round with priority_claim_schedule).  Replicated:
// k = live ? min(tail - head, S * batch) : 0, share = k / S, rem = k % S;
// lane (i, j) is active iff j < share + (i < rem) and consumes ticket
// head + i * share + min(i, rem) + j; head += k.
// Sharded: occ = tails - heads, k = live ? min(sum(occ), S * batch) : 0,
// shard i takes min(share + (p_i < rem), occ_i, batch) where p_i is its
// place among the shards by occupancy (fullest first, ties by index: the
// stable argsort of -occ), consuming heads[i] + j from its own ring, and
// heads[i] += its count.  pops[i] gets shard i's count, k_out the sum.
// ring >= 0 (sharded): only shard `ring` consumes, into row 0 of vals and
// ok.  kPacked: births[lane] gets the consumed stamp (-1 on a miss).
template <bool kSharded, bool kPacked>
__global__ void __launch_bounds__(kWaveThreads)
    ring_dequeue_wave_kernel(int32_t* __restrict__ cyc,
                             int32_t* __restrict__ saf,
                             const int32_t* __restrict__ enq,
                             int32_t* __restrict__ idx,
                             int32_t* __restrict__ heads,
                             const int32_t* __restrict__ tails,
                             const bool* __restrict__ live,
                             int32_t* __restrict__ vals,
                             bool* __restrict__ ok,
                             int32_t* __restrict__ pops,
                             int32_t* __restrict__ k_out,
                             int32_t* __restrict__ births, int shards,
                             int batch, int s, int32_t idx_bot, int ring) {
  extern __shared__ int32_t grid_smem[];
  int32_t* s_cnt = grid_smem;                     // lanes a shard claims
  uint32_t* s_base =                              // its first ticket
      reinterpret_cast<uint32_t*>(grid_smem + shards);
  int32_t* s_occ = grid_smem + 2 * shards;        // sharded: occupancies
  __shared__ int32_t s_share, s_rem, s_k;
  const int32_t grid = shards * batch;
  if (kSharded) {
    for (int i = threadIdx.x; i < shards; i += blockDim.x) {
      const uint32_t h = static_cast<uint32_t>(heads[i]);
      s_base[i] = h;
      s_occ[i] = static_cast<int32_t>(static_cast<uint32_t>(tails[i]) - h);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t sum = 0;
      for (int i = 0; i < shards; ++i) sum += static_cast<uint32_t>(s_occ[i]);
      const int32_t k = live[0] ? min(static_cast<int32_t>(sum), grid) : 0;
      s_share = k / shards;
      s_rem = k % shards;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < shards; i += blockDim.x) {
      const int32_t o = s_occ[i];
      int p = 0;  // shards ahead of i: fuller, or as full at a lower index
      for (int u = 0; u < shards; ++u)
        p += s_occ[u] > o || (s_occ[u] == o && u < i);
      const int32_t c =
          min(s_share + (p < s_rem ? 1 : 0), min(o, batch));
      s_cnt[i] = c;
      pops[i] = c;
      heads[i] = static_cast<int32_t>(s_base[i] + static_cast<uint32_t>(c));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t k = 0;
      for (int i = 0; i < shards; ++i) k += s_cnt[i];
      k_out[0] = k;
    }
  } else {
    __shared__ uint32_t s_head;
    if (threadIdx.x == 0) {
      const uint32_t h = static_cast<uint32_t>(heads[0]);
      const int32_t occ =
          static_cast<int32_t>(static_cast<uint32_t>(tails[0]) - h);
      const int32_t k = live[0] ? min(occ, grid) : 0;
      s_head = h;
      s_k = k;
      s_share = k / shards;
      s_rem = k % shards;
    }
    __syncthreads();
    const int32_t share = s_share, rem = s_rem;
    for (int i = threadIdx.x; i < shards; i += blockDim.x) {
      const int32_t c = share + (i < rem ? 1 : 0);
      s_cnt[i] = c;
      s_base[i] = s_head + static_cast<uint32_t>(i * share + min(i, rem));
      pops[i] = c;
    }
    __syncthreads();
    // only thread 0 read head from memory, so it may write it back now
    if (threadIdx.x == 0) {
      heads[0] = static_cast<int32_t>(s_head + static_cast<uint32_t>(s_k));
      k_out[0] = s_k;
    }
  }
  const int rows = ring < 0 ? shards : 1;  // rows of vals and ok
  for (int lane = threadIdx.x; lane < rows * batch; lane += blockDim.x) {
    const int r = rows == 1 ? 0 : lane / batch;
    const int i = ring < 0 ? r : ring;  // the row's shard
    const int j = lane - r * batch;
    const int64_t off = kSharded ? (static_cast<int64_t>(r) << s) : 0;
    int32_t v = -1, birth = -1;
    bool hit = false;
    if (j < s_cnt[i])
      hit = try_dequeue<kPacked>(cyc + off, saf + off, enq + off, idx + off,
                                 s_base[i] + static_cast<uint32_t>(j), s,
                                 idx_bot, &v, &birth);
    vals[lane] = v;
    ok[lane] = hit;
    if constexpr (kPacked) births[lane] = birth;
  }
}

// Where the child of global rank r installs: its ring's row offset, its
// ticket and that ring's head, and whether this launch holds that ring.
// Replicated: the one ring, tail + r.  Sharded: ring r % S at tails[r %
// S] + r / S (distqueue.py: dist_sharded_publish_round's round-robin
// spray); with local >= 0 only ring `local` is held, at offset 0.
struct GridSlot {
  int64_t off;
  uint32_t ticket, head;
  bool mine;
};

template <bool kSharded>
__device__ __forceinline__ GridSlot grid_slot(uint32_t r, int shards, int s,
                                              int local,
                                              const uint32_t* s_tail,
                                              const uint32_t* s_head) {
  if (!kSharded) return {0, s_tail[0] + r, s_head[0], true};
  const uint32_t ring = r % static_cast<uint32_t>(shards);
  return {local < 0 ? static_cast<int64_t>(ring) << s : 0,
          s_tail[ring] + r / static_cast<uint32_t>(shards), s_head[ring],
          local < 0 || ring == static_cast<uint32_t>(local)};
}

// A round's enqueue side, one launch (fusedrounds.py: RingEngine._round
// at S = 1; distqueue.py: dist_publish_round, dist_publish_compact_round,
// dist_sharded_publish_round).
// Ballot mode (kBallot, mask != null): the children are the set lanes of
// live & mask over the flattened (S * n,) child grid, ranked in lane order
// (shard-major, the reference's cumsum of the gathered mask).  Dense mode
// (the rows compacted by B3): values (S, n) and counts (S,) the rows'
// true popcounts; lane (i, j) is a child iff live and j < min(counts[i],
// n), of rank exclusive_prefix(counts)[i] + j (the reference's
// _compact_grid).  total = the children's count.  Replicated: over =
// int32(tail + total - head) > capacity; unless over, child r installs
// at ticket tail + r and tail += total; pushes[i] = shard i's children.
// Sharded: assigned[i] = total / S + (i < total % S), over = any(int32(
// tails[i] - heads[i]) + assigned[i] > capacity) (capacity is one
// ring's); unless over, child r installs on ring r % S at tails[r % S] +
// r / S and tails += assigned; pushes = assigned; with ring >= 0 only
// the children of ring `ring` install.  Over: nothing installs, tails
// stay, total_out and pushes are 0.  kPacked: the enq flag installed is
// (*birth_round << 1) | 1.
template <bool kBallot, bool kSharded, bool kPacked>
__global__ void __launch_bounds__(kWaveThreads)
    ring_enqueue_wave_kernel(int32_t* __restrict__ cyc,
                             int32_t* __restrict__ saf,
                             int32_t* __restrict__ enq,
                             int32_t* __restrict__ idx,
                             const int32_t* __restrict__ heads,
                             int32_t* __restrict__ tails,
                             const bool* __restrict__ live,
                             const int32_t* __restrict__ values,
                             const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ counts,
                             const int32_t* __restrict__ birth_round,
                             int32_t* __restrict__ total_out,
                             bool* __restrict__ over_out,
                             int32_t* __restrict__ pushes, int n, int shards,
                             int capacity, int s, int32_t idx_bot,
                             int ring) {
  extern __shared__ int32_t grid_smem[];
  int32_t* s_cnt = grid_smem;                     // children by shard
  uint32_t* s_head = reinterpret_cast<uint32_t*>(grid_smem + shards);
  uint32_t* s_tail = reinterpret_cast<uint32_t*>(grid_smem + 2 * shards);
  uint32_t* s_base0 =                             // dense: a row's first rank
      reinterpret_cast<uint32_t*>(grid_smem + 3 * shards);
  __shared__ uint32_t s_total;
  __shared__ int32_t s_flag;
  __shared__ bool s_live;
  const int rings = kSharded ? shards : 1;
  for (int i = threadIdx.x; i < rings; i += blockDim.x) {
    s_head[i] = static_cast<uint32_t>(heads[i]);
    s_tail[i] = static_cast<uint32_t>(tails[i]);
  }
  for (int i = threadIdx.x; i < shards; i += blockDim.x) s_cnt[i] = 0;
  if (threadIdx.x == 0) {
    s_live = live[0];
    if (kPacked)
      s_flag = static_cast<int32_t>(
          (static_cast<uint32_t>(birth_round[0]) << 1) | 1u);
  }
  __syncthreads();
  const int32_t flag = kPacked ? s_flag : 1;
  const int64_t lanes = static_cast<int64_t>(shards) * n;
  const int ntiles = static_cast<int>((lanes + kWaveTileLanes - 1) /
                                      kWaveTileLanes);
  uint32_t total, bits0 = 0, before0 = 0;
  if (kBallot) {
    // pass 1: the grid's popcount and each shard's; a one-tile grid keeps
    // its bits and its ranks, which are this scan's
    uint32_t mine = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const uint32_t b =
          s_live ? ballot_bits(mask, tile, static_cast<int>(lanes)) : 0u;
      if (tile == 0) bits0 = b;
      // the replicated ring's children by shard (its pushes): mostly one
      // row a thread; one shard's count is the total
      if (!kSharded && shards > 1 && b != 0u) {
        const int64_t i0 =
            static_cast<int64_t>(tile) * kWaveTileLanes +
            static_cast<int64_t>(threadIdx.x) * kWaveLanesPerThread;
        const int first = static_cast<int>((i0 + __ffs(b) - 1) / n);
        const int last = static_cast<int>((i0 + 31 - __clz(b)) / n);
        if (first == last) {
          atomicAdd(&s_cnt[first], __popc(b));
        } else {
          for (int j = 0; j < kWaveLanesPerThread; ++j)
            if ((b >> j) & 1u) atomicAdd(&s_cnt[(i0 + j) / n], 1);
        }
      }
      mine += __popc(b);
    }
    before0 = block_exclusive_sum(mine, &total);  // syncs: s_cnt complete
  } else {
    if (threadIdx.x == 0) {
      uint32_t sum = 0;
      for (int i = 0; i < shards; ++i) {
        const int32_t c = s_live ? counts[i] : 0;
        s_cnt[i] = c;
        s_base0[i] = sum;
        sum += static_cast<uint32_t>(c);
      }
      s_total = sum;
    }
    __syncthreads();
    total = s_total;
  }
  const uint32_t share = total / static_cast<uint32_t>(shards);
  const uint32_t rem = total % static_cast<uint32_t>(shards);
  bool over;
  if (kSharded) {
    bool mine = false;
    for (int i = threadIdx.x; i < shards; i += blockDim.x) {
      const int32_t assigned =
          static_cast<int32_t>(share + (static_cast<uint32_t>(i) < rem));
      mine |= static_cast<int32_t>(s_tail[i] - s_head[i]) + assigned >
              static_cast<int32_t>(capacity);
    }
    over = __syncthreads_or(mine) != 0;
  } else {
    over = static_cast<int32_t>(s_tail[0] + total - s_head[0]) >
           static_cast<int32_t>(capacity);
  }
  if (!over && total != 0u) {
    if (kBallot) {
      // pass 2: rank tile by tile in lane order and install
      uint32_t base = 0;
      for (int tile = 0; tile < ntiles; ++tile) {
        uint32_t b = bits0, tile_count = total, rank = base + before0;
        if (ntiles > 1) {
          b = ballot_bits(mask, tile, static_cast<int>(lanes));
          rank = base + block_exclusive_sum(__popc(b), &tile_count);
        }
        const int64_t i0 =
            static_cast<int64_t>(tile) * kWaveTileLanes +
            static_cast<int64_t>(threadIdx.x) * kWaveLanesPerThread;
        // every gather of this thread's lanes, then every install
        EnqSlot e[kWaveLanesPerThread] = {};
        GridSlot g[kWaveLanesPerThread] = {};
        int32_t v[kWaveLanesPerThread] = {};
#pragma unroll
        for (int j = 0; j < kWaveLanesPerThread; ++j) {
          if ((b >> j) & 1u) {
            g[j] = grid_slot<kSharded>(rank++, shards, s, ring, s_tail,
                                       s_head);
            if (g[j].mine) {
              v[j] = values[i0 + j];
              e[j] = enq_gather(cyc + g[j].off, saf + g[j].off,
                                idx + g[j].off, g[j].ticket, s);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kWaveLanesPerThread; ++j)
          if (((b >> j) & 1u) && g[j].mine)
            enq_install(cyc + g[j].off, saf + g[j].off, enq + g[j].off,
                        idx + g[j].off, e[j], g[j].ticket, v[j], g[j].head, s,
                        idx_bot, flag);
        base += tile_count;
      }
    } else {
      // row by row over its children only: a compacted row is mostly
      // empty lanes
      for (int i = 0; i < shards; ++i) {
        const int c = min(s_cnt[i], n);
        const int32_t* __restrict__ row = values + static_cast<int64_t>(i) * n;
        for (int j = threadIdx.x; j < c; j += blockDim.x) {
          const GridSlot g = grid_slot<kSharded>(
              s_base0[i] + static_cast<uint32_t>(j), shards, s, ring, s_tail,
              s_head);
          if (g.mine)
            try_enqueue(cyc + g.off, saf + g.off, enq + g.off, idx + g.off,
                        g.ticket, row[j], g.head, s, idx_bot, flag);
        }
      }
    }
  }
  // tails were read before the first barrier, by the threads that write
  // them back now
  for (int i = threadIdx.x; i < shards; i += blockDim.x) {
    const uint32_t assigned = share + (static_cast<uint32_t>(i) < rem);
    if (kSharded) {
      tails[i] = static_cast<int32_t>(s_tail[i] + (over ? 0u : assigned));
      pushes[i] = over ? 0 : static_cast<int32_t>(assigned);
    } else {
      pushes[i] = over ? 0 : shards == 1 ? static_cast<int32_t>(total)
                                         : s_cnt[i];
    }
  }
  if (threadIdx.x == 0) {
    if (!kSharded)
      tails[0] = static_cast<int32_t>(s_tail[0] + (over ? 0u : total));
    total_out[0] = over ? 0 : static_cast<int32_t>(total);
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

// Planes: four (1 << s,) int32; tickets, vals: (b,) int32; ok: (b,) bool;
// active: (b,) bool, or null for "ticket >= 0".  b > 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_ring_dequeue(void* cyc, void* saf, const void* enq,
                                  void* idx, const void* tickets,
                                  const void* active, void* vals, void* ok,
                                  int b, int s, int idx_bot, void* stream) {
  const int blocks = (b + repro::kThreads - 1) / repro::kThreads;
  repro::ring_dequeue_kernel<<<blocks, repro::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<const int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<const int32_t*>(tickets), static_cast<const bool*>(active),
      static_cast<int32_t*>(vals), static_cast<bool*>(ok), b, s, idx_bot);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus values: (b,) int32 and head: (1,) int32.
extern "C" int repro_ring_enqueue(void* cyc, void* saf, void* enq, void* idx,
                                  const void* tickets, const void* active,
                                  const void* values, const void* head,
                                  void* ok, int b, int s, int idx_bot,
                                  void* stream) {
  const int blocks = (b + repro::kThreads - 1) / repro::kThreads;
  repro::ring_enqueue_kernel<<<blocks, repro::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<const int32_t*>(tickets), static_cast<const bool*>(active),
      static_cast<const int32_t*>(values),
      static_cast<const int32_t*>(head), static_cast<bool*>(ok), b, s,
      idx_bot);
  return static_cast<int>(cudaGetLastError());
}

// The dequeue wave over an S x batch grid (one launch).  Replicated
// (sharded == 0): planes four (1 << s,) int32, heads and tails 0-d int32.
// Sharded: planes four (S, 1 << s) int32, heads and tails (S,) int32;
// with ring >= 0 (sharded only; -1 otherwise) planes four (1 << s,), ring
// `ring` of the S, and vals and ok (batch,).  heads is updated in place.
// live: 0-d bool; vals: (S * batch,) int32; ok: (S * batch,) bool; pops:
// (S,) int32; k: 0-d int32; births: (S * batch,) int32 for the packed
// instance (replicated only) or null.  1 <= S <= kMaxShards, S * batch <
// 2^31.  Returns cudaGetLastError() after the launch.
extern "C" int repro_ring_dequeue_wave(void* cyc, void* saf, const void* enq,
                                       void* idx, void* heads,
                                       const void* tails, const void* live,
                                       void* vals, void* ok, void* pops,
                                       void* k, void* births, int shards,
                                       int batch, int sharded, int s,
                                       int idx_bot, int ring, void* stream) {
  using namespace repro;
  const bool packed = births != nullptr;
  if (shards < 1 || shards > kMaxShards || batch < 0 ||
      static_cast<int64_t>(shards) * batch >= (int64_t{1} << 31) ||
      (sharded && packed) || ring >= shards || (ring >= 0 && !sharded))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = sharded ? ring_dequeue_wave_kernel<true, false>
                 : packed ? ring_dequeue_wave_kernel<false, true>
                          : ring_dequeue_wave_kernel<false, false>;
  const int threads = wave_threads(
      static_cast<int64_t>(shards) * batch > shards
          ? static_cast<int64_t>(shards) * batch : shards);
  kernel<<<1, threads, 3 * shards * sizeof(int32_t),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<const int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(heads), static_cast<const int32_t*>(tails),
      static_cast<const bool*>(live), static_cast<int32_t*>(vals),
      static_cast<bool*>(ok), static_cast<int32_t*>(pops),
      static_cast<int32_t*>(k), static_cast<int32_t*>(births), shards, batch,
      s, idx_bot, ring < 0 ? -1 : ring);
  return static_cast<int>(cudaGetLastError());
}

// The enqueue wave over an S x n child grid (one launch).  Planes, heads
// and tails as for the dequeue wave; tails is updated in place.  live,
// over: 0-d bool; total: 0-d int32; pushes: (S,) int32.  Ballot mode:
// values and mask (S * n,) int32 and bool, counts null.  Dense mode:
// values (S, n) int32, counts (S,) int32, mask null.  birth_round: a 0-d
// int32 for the packed instance (replicated only), or null.  capacity:
// the ring's (one ring's when sharded).  ring: -1, or (sharded only) the
// one ring of the S the planes hold, as for the dequeue wave.  1 <= S <=
// kMaxShards, S * n < 2^31.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_ring_enqueue_wave(void* cyc, void* saf, void* enq,
                                       void* idx, const void* heads,
                                       void* tails, const void* live,
                                       const void* values, const void* mask,
                                       const void* counts,
                                       const void* birth_round, void* total,
                                       void* over, void* pushes, int n,
                                       int shards, int sharded, int capacity,
                                       int s, int idx_bot, int ring,
                                       void* stream) {
  using namespace repro;
  const int64_t lanes = static_cast<int64_t>(shards) * n;
  const bool packed = birth_round != nullptr;
  if (n < 0 || shards < 1 || shards > kMaxShards ||
      lanes >= (int64_t{1} << 31) ||
      (mask == nullptr) == (counts == nullptr) || (sharded && packed) ||
      ring >= shards || (ring >= 0 && !sharded))
    return static_cast<int>(cudaErrorInvalidValue);
  // a ballot wave of one tile runs only the threads its lanes need
  const bool ballot = mask != nullptr;
  const int threads =
      !ballot ? wave_threads(lanes)
      : lanes > kWaveTileLanes
          ? kWaveThreads
          : wave_threads((lanes + kWaveLanesPerThread - 1) /
                         kWaveLanesPerThread);
  auto* kernel =
      ballot ? (sharded  ? ring_enqueue_wave_kernel<true, true, false>
                : packed ? ring_enqueue_wave_kernel<true, false, true>
                         : ring_enqueue_wave_kernel<true, false, false>)
             : (sharded  ? ring_enqueue_wave_kernel<false, true, false>
                : packed ? ring_enqueue_wave_kernel<false, false, true>
                         : ring_enqueue_wave_kernel<false, false, false>);
  kernel<<<1, threads, 4 * shards * sizeof(int32_t),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cyc), static_cast<int32_t*>(saf),
      static_cast<int32_t*>(enq), static_cast<int32_t*>(idx),
      static_cast<const int32_t*>(heads), static_cast<int32_t*>(tails),
      static_cast<const bool*>(live), static_cast<const int32_t*>(values),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(birth_round), static_cast<int32_t*>(total),
      static_cast<bool*>(over), static_cast<int32_t*>(pushes), n, shards,
      capacity, s, idx_bot, ring < 0 ? -1 : ring);
  return static_cast<int>(cudaGetLastError());
}
