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
// Bound: a chain of dependent loads.  A pop reads the d children of each
// level before it knows where to go next, and the ops are serial by
// definition (batch order is the linearization order), so one thread
// applies them and a batch costs about pops x depth dependent loads, each
// paying the full latency of every instruction on its path (no other warp
// runs beside it).  The design shortens each link of that chain:
//
//   * Resident top.  The block loads nodes [0, R) of both planes into
//     dynamic shared memory as interleaved (key, val) pairs, R =
//     min(2^cap_log2, R_max).  R_max is the largest whole number of levels
//     that fits beside the tail window and the op staging in the 227 KB a
//     block may opt into: levels 0-7 of a 4-ary heap (21,845 nodes, 174,760
//     B), levels 0-13 of a binary one (16,383 nodes, 131,064 B) or levels
//     0-4 of an 8-ary one (4,681 nodes, 37,448 B).  Node j sits at slot
//     j + d - 1, so each sibling group is one, two or four aligned 128-bit
//     loads.  A pop's sift runs through the top in a loop with no
//     region tests and 32-bit indices.
//   * Tail window.  kWindow nodes from kWindow / 2 below the call's first
//     size (whole sibling groups past the top) are resident too: there a
//     pop takes its last leaf and scrubs it, and an insert opens its hole.
//   * Heaps of up to R nodes never touch device memory inside the call; at
//     the end the block writes back the resident nodes below the largest
//     size of the call.
//   * The d children (key and val) are independent loads and the winner
//     comes from a compare tree that keeps the serial scan's choice: the
//     lowest index among the strict minima, none when all are KEY_INF.
//     Below the top, the grandchildren are loaded while the children are
//     decided, so two levels cost one round trip (binary and 4-ary; an
//     8-ary group's 64 grandchildren would not fit in registers).
//   * An insert loads its grandparent while it tests its parent.
//   * The block stages only the INSERT and DELETE-MIN lanes of each chunk,
//     in lane order (a block scan), and writes every other lane's outputs
//     itself, so NOP lanes cost the serial thread nothing.
//
// Measured (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, 700.00 W) on the
// priority path's 2^20-slot heap at 211,890 nodes: 1.20 ms a 1,024-pop
// call and 0.33 ms a 2,048-lane insert call, 0.76 ms their mean (the
// serial design this replaces: 0.91 ms).  A pop's level below the top,
// an L2 round trip, is most of what is left.  Tried and slower on the
// card: a pop that first walks the whole path of least children, two top
// levels a step, the warp in lockstep holding the first levels below the
// top in registers, and L1 or L2 prefetches of those levels.
//
// Its bytes bound counts the opcodes in (4 B per op) and the key and val
// of each INSERT lane (8 B), the results out (9 B per op), the size word
// each way, per pop the root, the last leaf and its scrub (24 B) and per
// sift-down level d child keys, the winner's val and one node written
// (4d + 12 B), and per applied insert one parent key read and its node
// written (12 B): tens of nanoseconds at HBM rate.  Its dependent-chain
// bound (chip_smoke.py) is pops x (levels in the top x a shared-memory
// round trip + levels below it x an L2 round trip).
//
// The rider instance (heap_batch.py: heap_apply(rider=, oprider=), the
// span layer's birth stamps; reference heap_planes(rider=)) moves a third
// int32 plane with every node: INSERT lanes install oprider (one device
// word, or one per lane), DELETE-MIN lanes return the popped node's
// rider.  A node's rider sits beside its (key, val) in the same region:
// a second shared-memory array with the top's and the window's slots, the
// rider plane below them.  Every load of a node or a sibling group also
// loads its riders, as independent loads in the same round trip, so the
// dependent chain has no extra link; what the instance pays is shared
// memory.  Twelve bytes a node do not fit the rider-less top (21,845
// 4-ary nodes would take 262 KB), so the rider instance holds one level
// fewer: levels 0-6 of a 4-ary heap (5,461 nodes), 0-12 of a binary one
// (8,191), and the same levels 0-4 of an 8-ary one; below the top it
// loads one level at a time (kLookAhead).  The rider-less instance is the
// kernel above, unchanged.
//
// The shard grid (heap_batch.py: heap_apply_grid; reference
// heap_pop_count / heap_insert_masked on each shard's heap under the
// priority mesh's shard_map) applies one wave to S heaps stacked (S, 2^c)
// in ONE launch of S blocks: block s is the kernel above on heap s, its
// size word sizes[s] read at the start and written at the end (in place).
// Its ops are not given lane by lane but made where the block stages
// them (template M):
//
//   * pop-count (kPopCount): lane i of block s is DELETE-MIN when i <
//     counts[s], else NOP; its results are row s of (S, b) outputs;
//   * masked insert (kMaskedInsert): every block reads the one gathered
//     wave (okeys, ovals, oprider) of b lanes and a destination per lane,
//     and lane i is INSERT in block s when dest[i] == s, else NOP (-1 goes
//     nowhere); no per-lane results are written.
//
// Staging keeps only INSERT and DELETE-MIN lanes, so a block's serial
// thread walks its own shard's lanes and nothing else.  The blocks are
// independent and each takes an SM of its own (its shared memory fills
// one), so a wave over S <= 132 heaps costs about one heap's call.  The
// single heap's instance (kOpsGiven, heap_apply) is unchanged: one block,
// its ops read lane by lane.
//
// Arities above 8 (arity_log2 >= 4, as the Pallas kernel takes any): one
// instance a rider and op mode, A = 0, whose arity is a launch argument.
// It keeps no shared-memory top and no window: its serial thread runs the
// Pallas body on the planes in device memory, a child scan of up to 2^a
// loads a level (a 256-ary heap of 2^20 slots is three levels deep).  The
// staging and the outputs are the instances' above.  Shifts are clamped
// at 31: past that a node's parent is the root and the root's children
// are every other node, as they are at 31.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace repro {

constexpr int32_t kKeyInf = 0x7fffffff;
constexpr int32_t kOpInsert = 0;
constexpr int32_t kOpDelmin = 1;
constexpr int32_t kOpNop = -1;
constexpr int kHeapThreads = 256;
// where a block's ops come from (see the grid above)
constexpr int kOpsGiven = 0;
constexpr int kPopCount = 1;
constexpr int kMaskedInsert = 2;
constexpr int kChunk = 1024;  // ops staged in shared memory at a time
constexpr int kOpsPerThread = kChunk / kHeapThreads;
// staging: lane | op, key, val, the outputs (key, val, ok) and, for the
// rider instance, the op's rider and the popped rider
template <bool R>
constexpr int kStageBytes = kChunk * ((R ? 7 : 5) * 4 + 1);
// The tail window: nodes around the call's first size, where its pops
// take their last leaves (and scrub them) and its inserts open their holes.
constexpr int kWindow = 4096;

// Nodes in the whole levels that fit in shared memory: sum of d^l
// (levels 0-13 binary, 0-7 4-ary, 0-4 8-ary; with a rider 0-12 binary,
// 0-6 4-ary, 0-4 8-ary; none for the runtime arity, A = 0).
template <int A, bool R>
constexpr int kResidentMax = A == 0   ? 0
                             : A == 1 ? (R ? 8191 : 16383)
                             : A == 2 ? (R ? 5461 : 21845)
                                      : 4681;
// the tail window's nodes (none for the runtime arity)
template <int A>
constexpr int kWin = A == 0 ? 0 : kWindow;
// Below the top a pop loads its grandchildren while it decides between
// the children: D^2 keys and vals in registers, 32 at 4-ary; at 8-ary
// (128) they would not fit, so each level loads its own children there.
// The rider instance loads each level's own children too: with riders a
// 4-ary level keeps 48 loads in flight, and on the card that made its
// pops slower than loading one level at a time.
template <int A, bool R>
constexpr bool kLookAhead = A >= 1 && A <= 2 && !R;

// Shared memory: the top (node j at slot j + D - 1, so that every sibling
// group starts on a 16- or 32-byte boundary, and D - 1 + D slots of
// padding), the window, for the rider instance the riders of the top and
// of the window at the same slots, then the op staging.
template <int A, bool R>
constexpr int kTopSlots = (kResidentMax<A, R> + 2 * (1 << A) + 3) & ~3;
template <int A, bool R>
constexpr int kSmemBytes =
    (kTopSlots<A, R> + kWin<A>) * (R ? 12 : 8) + kStageBytes<R>;

template <int A, bool R>
struct Heap {
  static constexpr int D = 1 << A;
  int2* top;  // node j < r at top[j + D - 1], as (key, val)
  int2* win;  // node j in [w0, w0 + wn) at win[j - w0]; w0 = 1 mod D
  int32_t* rtop;  // R: node j's rider at rtop[j + D - 1]
  int32_t* rwin;  // R: node j's rider at rwin[j - w0]
  int32_t* keys;
  int32_t* vals;
  int32_t* rid;   // R: the rider plane
  uint32_t r, w0, wn;

  __device__ __forceinline__ int2 node(uint32_t j) const {
    if (j < r) return top[j + D - 1];
    if (j - w0 < wn) return win[j - w0];
    return make_int2(keys[j], vals[j]);
  }
  __device__ __forceinline__ int32_t rider(uint32_t j) const {
    if (j < r) return rtop[j + D - 1];
    if (j - w0 < wn) return rwin[j - w0];
    return rid[j];
  }
  // node j := (k, v), and its rider := rr in the rider instance
  __device__ __forceinline__ void put(uint32_t j, int32_t k, int32_t v,
                                      int32_t rr = 0) const {
    if (j < r) {
      top[j + D - 1] = make_int2(k, v);
      if constexpr (R) rtop[j + D - 1] = rr;
    } else if (j - w0 < wn) {
      win[j - w0] = make_int2(k, v);
      if constexpr (R) rwin[j - w0] = rr;
    } else {
      keys[j] = k;
      vals[j] = v;
      if constexpr (R) rid[j] = rr;
    }
  }
  // the sibling group from `base` (= 1 mod D) at `g` in shared memory,
  // (KEY_INF, -1) at or past `size`; the rider instance also reads its
  // riders from `rg` (-1 at or past `size`)
  __device__ __forceinline__ static void smem_group(const int2* g,
                                                    const int32_t* rg,
                                                    uint32_t base,
                                                    uint32_t size, int32_t* k,
                                                    int32_t* v, int32_t* rv) {
    int32_t x[2 * D];
#pragma unroll
    for (int q = 0; q < D / 2; ++q) {
      const int4 a = reinterpret_cast<const int4*>(g)[q];
      x[4 * q] = a.x;
      x[4 * q + 1] = a.y;
      x[4 * q + 2] = a.z;
      x[4 * q + 3] = a.w;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const bool in = base + c < size;
      k[c] = in ? x[2 * c] : kKeyInf;
      v[c] = in ? x[2 * c + 1] : -1;
      if constexpr (R) rv[c] = in ? rg[c] : -1;
    }
  }
  // the same wherever the group lies.  A group lies whole in one region:
  // r is a whole number of levels or the capacity, w0 = 1 mod D and wn a
  // multiple of D or the rest of the planes.
  __device__ __forceinline__ void group(uint32_t base, uint32_t size,
                                        int32_t* k, int32_t* v,
                                        int32_t* rv) const {
    if (base < r) {
      smem_group(top + base + D - 1, rtop + base + D - 1, base, size, k, v,
                 rv);
    } else if (base - w0 < wn) {
      smem_group(win + (base - w0), rwin + (base - w0), base, size, k, v,
                 rv);
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const bool in = base + c < size;
        k[c] = in ? keys[base + c] : kKeyInf;
        v[c] = in ? vals[base + c] : -1;
        if constexpr (R) rv[c] = in ? rid[base + c] : -1;
      }
    }
  }
};

// Lowest index among the strict minima of k[0..N), or -1 when all are
// KEY_INF: the serial scan from (KEY_INF, -1) that takes strictly smaller
// keys, as a compare tree.  *bk / *bv (and *br, with a rider) get the
// winner's key and val (and rider).
template <int N, bool R>
__device__ __forceinline__ int min_child(const int32_t* k, const int32_t* v,
                                         const int32_t* rv, int32_t* bk,
                                         int32_t* bv, int32_t* br) {
  int32_t kk[N], vv[N], rr[N];
  int ii[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    kk[c] = k[c];
    vv[c] = v[c];
    if constexpr (R) rr[c] = rv[c];
    ii[c] = c;
  }
#pragma unroll
  for (int w = 1; w < N; w <<= 1) {
#pragma unroll
    for (int c = 0; c + w < N; c += 2 * w) {
      if (kk[c + w] < kk[c]) {  // ties keep the lower index
        kk[c] = kk[c + w];
        vv[c] = vv[c + w];
        if constexpr (R) rr[c] = rr[c + w];
        ii[c] = ii[c + w];
      }
    }
  }
  *bk = kk[0];
  *bv = vv[0];
  if constexpr (R) *br = rr[0];
  return kk[0] < kKeyInf ? ii[0] : -1;
}

// One op of the runtime-arity instance (A = 0) on the planes in device
// memory, the Pallas body step for step: returns whether it applied and
// sets *rk / *rv / *rr to a DELETE-MIN's popped node.
template <bool R>
__device__ __forceinline__ uint8_t apply_any(
    int32_t op, int32_t key, int32_t val, int32_t orid, int32_t* keys,
    int32_t* vals, int32_t* rid, int32_t* size, uint32_t cap, int a,
    int max_depth, int32_t* rk, int32_t* rv, int32_t* rr) {
  const int s = a < 31 ? a : 31;
  if (op == kOpInsert && static_cast<uint32_t>(*size) < cap) {
    uint32_t j = static_cast<uint32_t>(*size);
    for (int t = 0; t < max_depth && j > 0; ++t) {
      const uint32_t p = (j - 1) >> s;
      const int32_t pk = keys[p];
      if (!(pk > key)) break;
      keys[j] = pk;
      vals[j] = vals[p];
      if constexpr (R) rid[j] = rid[p];
      j = p;
    }
    keys[j] = key;
    vals[j] = val;
    if constexpr (R) rid[j] = orid;
    ++*size;
    return 1;
  }
  if (op != kOpDelmin || *size <= 0) return 0;
  const uint32_t nsize = static_cast<uint32_t>(*size) - 1;
  *rk = keys[0];
  *rv = vals[0];
  if constexpr (R) *rr = rid[0];
  const int32_t lk = keys[nsize], lv = vals[nsize];
  int32_t lr = 0;
  if constexpr (R) lr = rid[nsize];
  if (nsize > 0) {
    uint32_t j = 0;
    for (int t = 0; t < max_depth; ++t) {
      const uint64_t base = (static_cast<uint64_t>(j) << s) + 1;
      const uint64_t end0 = base + (uint64_t{1} << s);
      const uint64_t end = end0 < nsize ? end0 : nsize;
      int32_t bk = kKeyInf;
      int64_t bj = -1;
#pragma unroll 8
      for (uint64_t c = base; c < end; ++c) {
        const int32_t ck = keys[c];
        if (ck < bk) {
          bk = ck;
          bj = static_cast<int64_t>(c);
        }
      }
      if (bj < 0 || !(bk < lk)) break;
      keys[j] = bk;
      vals[j] = vals[bj];
      if constexpr (R) rid[j] = rid[bj];
      j = static_cast<uint32_t>(bj);
    }
    keys[j] = lk;
    vals[j] = lv;
    if constexpr (R) rid[j] = lr;
  }
  // scrub the vacated tail slot so stale keys can't resurface
  keys[nsize] = kKeyInf;
  vals[nsize] = -1;
  if constexpr (R) rid[nsize] = -1;
  *size = static_cast<int32_t>(nsize);
  return 1;
}

// R: rid is the rider plane, oprider[opr_stride * lane] an INSERT lane's
// rider, outr[lane] a DELETE-MIN lane's popped rider (-1 elsewhere).
// M: kOpsGiven reads ops[lane]; on the grid, sel is counts (S,)
// (kPopCount) or dest (b,) (kMaskedInsert), and block s works on heap s.
// size_in and size_out may be one buffer: every thread reads its word
// before the first barrier, thread 0 writes it after the last.
template <int A, bool R, int M>
__global__ void __launch_bounds__(kHeapThreads)
heap_apply_kernel(int32_t* __restrict__ keys, int32_t* __restrict__ vals,
                  const int32_t* size_in,
                  const int32_t* __restrict__ ops,
                  const int32_t* __restrict__ okeys,
                  const int32_t* __restrict__ ovals,
                  int32_t* __restrict__ outk, int32_t* __restrict__ outv,
                  uint8_t* __restrict__ ok, int32_t* size_out,
                  int b, int cap_log2, int max_depth,
                  int32_t* __restrict__ rid,
                  const int32_t* __restrict__ oprider, int opr_stride,
                  int32_t* __restrict__ outr,
                  const int32_t* __restrict__ sel, int arity_log2) {
  constexpr int D = 1 << A;
  constexpr bool kOut = M != kMaskedInsert;  // per-lane results written
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t cap = 1u << cap_log2;
  const int32_t shard = M == kOpsGiven ? 0 : static_cast<int32_t>(blockIdx.x);
  if constexpr (M != kOpsGiven) {
    const int64_t plane = static_cast<int64_t>(shard) << cap_log2;
    keys += plane;
    vals += plane;
    if constexpr (R) rid += plane;
    size_in += shard;
    size_out += shard;
  }
  if constexpr (M == kPopCount) {
    const int64_t row = static_cast<int64_t>(shard) * b;
    outk += row;
    outv += row;
    ok += row;
    if constexpr (R) outr += row;
  }
  int32_t pops = 0;  // kPopCount: the lanes below it pop
  if constexpr (M == kPopCount) pops = sel[shard];
  const uint32_t r =
      cap < kResidentMax<A, R> ? cap : kResidentMax<A, R>;
  int32_t size = *size_in;
  // the window: kWindow nodes from about kWindow / 2 below the first
  // size, a whole number of sibling groups past the top, within the planes
  int64_t lo = static_cast<int64_t>(size) - kWindow / 2 - 1;
  lo = lo > 0 ? lo / D * D + 1 : 1;
  const uint32_t w0 = lo > r ? static_cast<uint32_t>(lo) : r;
  const uint32_t wn = A == 0 || w0 >= cap
                          ? 0u
                          : (cap - w0 < kWindow ? cap - w0 : kWindow);
  int2* top = reinterpret_cast<int2*>(smem);
  int2* win = top + kTopSlots<A, R>;
  int32_t* rtop = reinterpret_cast<int32_t*>(win + kWin<A>);
  int32_t* rwin = rtop + (R ? kTopSlots<A, R> : 0);
  int32_t* s_op = rwin + (R ? kWin<A> : 0);
  int32_t* s_key = s_op + kChunk;
  int32_t* s_val = s_key + kChunk;
  int32_t* s_outk = s_val + kChunk;
  int32_t* s_outv = s_outk + kChunk;
  int32_t* s_rid = s_outv + kChunk;            // R only
  int32_t* s_outr = s_rid + kChunk;            // R only
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(R ? s_outr + kChunk : s_rid);
  const Heap<A, R> h{top, win, rtop, rwin, keys, vals, rid, r, w0, wn};

  // nodes past `size` are written before they are read, so only the live
  // part of the top and of the window is loaded
  const uint32_t usize = static_cast<uint32_t>(size);
  const uint32_t live = usize < r ? usize : r;
#pragma unroll 4
  for (uint32_t j = threadIdx.x; j < live; j += kHeapThreads) {
    top[j + D - 1] = make_int2(keys[j], vals[j]);
    if constexpr (R) rtop[j + D - 1] = rid[j];
  }
  for (uint32_t j = threadIdx.x; j < wn && w0 + j < usize;
       j += kHeapThreads) {
    win[j] = make_int2(keys[w0 + j], vals[w0 + j]);
    if constexpr (R) rwin[j] = rid[w0 + j];
  }
  int32_t hi = size;  // the largest size of the call (thread 0)

  for (int c0 = 0; c0 < b; c0 += kChunk) {
    const int n = b - c0 < kChunk ? b - c0 : kChunk;
    // stage the chunk's INSERT and DELETE-MIN lanes, in lane order, as
    // (lane << 1 | op, key, val); every lane's outputs start as a NOP's
    int32_t op4[kOpsPerThread];
    uint32_t live = 0;
    const int q0 = threadIdx.x * kOpsPerThread;
#pragma unroll
    for (int q = 0; q < kOpsPerThread; ++q) {
      const int lane = c0 + q0 + q;
      if constexpr (M == kOpsGiven)
        op4[q] = q0 + q < n ? ops[lane] : kOpNop;
      else if constexpr (M == kPopCount)
        op4[q] = q0 + q < n && lane < pops ? kOpDelmin : kOpNop;
      else
        op4[q] = q0 + q < n && sel[lane] == shard ? kOpInsert : kOpNop;
      live += op4[q] == kOpInsert || op4[q] == kOpDelmin;
      if (kOut && q0 + q < n) {
        s_outk[q0 + q] = kKeyInf;
        s_outv[q0 + q] = -1;
        s_ok[q0 + q] = 0;
        if constexpr (R) s_outr[q0 + q] = -1;
      }
    }
    uint32_t nlive;
    uint32_t at = block_exclusive_sum(live, &nlive);
#pragma unroll
    for (int q = 0; q < kOpsPerThread; ++q) {
      if (op4[q] == kOpInsert || op4[q] == kOpDelmin) {
        s_op[at] = ((q0 + q) << 1) | op4[q];
        if constexpr (M != kPopCount) {  // a pop's key and val are unused
          s_key[at] = okeys[c0 + q0 + q];
          s_val[at] = ovals[c0 + q0 + q];
          if constexpr (R)
            s_rid[at] = oprider[static_cast<int64_t>(opr_stride) *
                                (c0 + q0 + q)];
        }
        ++at;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (uint32_t a = 0; a < nlive; ++a) {
        const int i = s_op[a] >> 1;
        const int32_t op = s_op[a] & 1;
        int32_t rk = kKeyInf, rv = -1, rr = -1;
        uint8_t applied = 0;
        if constexpr (A == 0) {
          int32_t orid = 0;
          if constexpr (R) orid = s_rid[a];
          applied = apply_any<R>(op, s_key[a], s_val[a], orid, keys, vals,
                                 rid, &size, cap, arity_log2, max_depth, &rk,
                                 &rv, &rr);
        } else if (op == kOpInsert && static_cast<uint32_t>(size) < cap) {
          // hole starts at `size`; parents move down while larger.  Each
          // step loads the grandparent before it tests the parent, so a
          // global level costs one round trip and no store waits on a
          // load.
          const int32_t key = s_key[a], val = s_val[a];
          int32_t orid = 0, pr = 0;
          if constexpr (R) orid = s_rid[a];
          uint32_t j = static_cast<uint32_t>(size);
          if (j > 0) {
            uint32_t p = (j - 1) >> A;
            int2 pn = h.node(p);
            if constexpr (R) pr = h.rider(p);
            for (int t = 0; t < max_depth && j > 0; ++t) {
              const uint32_t g = p > 0 ? (p - 1) >> A : 0u;
              const int2 gn = p > 0 ? h.node(g) : make_int2(kKeyInf, -1);
              int32_t gr = 0;
              if constexpr (R) gr = p > 0 ? h.rider(g) : -1;
              if (!(pn.x > key)) break;
              h.put(j, pn.x, pn.y, pr);
              j = p;
              p = g;
              pn = gn;
              pr = gr;
            }
          }
          h.put(j, key, val, orid);
          ++size;
          hi = size > hi ? size : hi;
          applied = 1;
        } else if (op == kOpDelmin && size > 0) {
          // root out; the last node sifts down into the hole: first
          // through the top, in shared memory with no region tests, then
          // below it, where the grandchildren are loaded while the
          // children are decided
          const uint32_t nsize = static_cast<uint32_t>(size) - 1;
          const int2 last = h.node(nsize);
          const int2 root = h.node(0);
          int32_t lastr = 0;
          if constexpr (R) {
            lastr = h.rider(nsize);
            rr = h.rider(0);
          }
          rk = root.x;
          rv = root.y;
          if (nsize > 0) {
            uint32_t j = 0, base = 1;
            int32_t ck[D], cv[D], cr[D], bk, bv, br = 0;
            int t = 0;
            bool moving = true;
            for (; t < max_depth && base < r; ++t) {
              Heap<A, R>::smem_group(top + base + D - 1, rtop + base + D - 1,
                                     base, nsize, ck, cv, cr);
              const int w = min_child<D, R>(ck, cv, cr, &bk, &bv, &br);
              if (w < 0 || !(bk < last.x)) {
                moving = false;
                break;
              }
              top[j + D - 1] = make_int2(bk, bv);
              if constexpr (R) rtop[j + D - 1] = br;
              j = base + w;
              base = (j << A) + 1;
            }
            if constexpr (!kLookAhead<A, R>) {
              // 8-ary and the rider instance: one sibling group a level,
              // loaded when it is needed
              for (; moving && t < max_depth && base < nsize; ++t) {
                h.group(base, nsize, ck, cv, cr);
                const int w = min_child<D, R>(ck, cv, cr, &bk, &bv, &br);
                if (w < 0 || !(bk < last.x)) break;
                h.put(j, bk, bv, br);
                j = base + w;
                base = (j << A) + 1;
              }
            } else if (moving && t < max_depth && base < nsize) {
              h.group(base, nsize, ck, cv, cr);
              for (; t < max_depth; ++t) {
                const uint32_t gbase = (base << A) + 1;
                const bool ahead = gbase < nsize;
                int32_t gk[D * D], gv[D * D];
                if (ahead) {
#pragma unroll
                  for (int c = 0; c < D; ++c)
                    h.group(gbase + c * D, nsize, gk + c * D, gv + c * D,
                            nullptr);
                }
                const int w = min_child<D, R>(ck, cv, cr, &bk, &bv, &br);
                if (w < 0 || !(bk < last.x)) break;
                h.put(j, bk, bv, br);
                j = base + w;
                base = gbase + (static_cast<uint32_t>(w) << A);
                if (!ahead) break;  // no grandchildren: j is a leaf
#pragma unroll
                for (int c = 0; c < D; ++c) {
                  ck[c] = gk[c];
                  cv[c] = gv[c];
#pragma unroll
                  for (int q = 1; q < D; ++q) {
                    if (w == q) {
                      ck[c] = gk[q * D + c];
                      cv[c] = gv[q * D + c];
                    }
                  }
                }
              }
            }
            h.put(j, last.x, last.y, lastr);
          }
          // scrub the vacated tail slot so stale keys can't resurface
          h.put(nsize, kKeyInf, -1, -1);
          size = nsize;
          applied = 1;
        }
        if constexpr (kOut) {
          s_outk[i] = rk;
          s_outv[i] = rv;
          if constexpr (R) s_outr[i] = rr;
          s_ok[i] = applied;
        }
      }
    }
    __syncthreads();
    if constexpr (kOut) {
      for (int t = threadIdx.x; t < n; t += kHeapThreads) {
        outk[c0 + t] = s_outk[t];
        outv[c0 + t] = s_outv[t];
        ok[c0 + t] = s_ok[t];
        if constexpr (R) outr[c0 + t] = s_outr[t];
      }
    }
    __syncthreads();  // the next chunk overwrites the staging buffers
  }
  // every resident node the call could have changed goes back
  __shared__ int32_t s_hi;
  if (threadIdx.x == 0) {
    s_hi = hi;
    *size_out = size;
  }
  __syncthreads();
  const uint32_t shi = static_cast<uint32_t>(s_hi);
  const uint32_t back = shi < r ? shi : r;
#pragma unroll 4
  for (uint32_t j = threadIdx.x; j < back; j += kHeapThreads) {
    const int2 x = top[j + D - 1];
    keys[j] = x.x;
    vals[j] = x.y;
    if constexpr (R) rid[j] = rtop[j + D - 1];
  }
  for (uint32_t j = threadIdx.x; j < wn && w0 + j < shi; j += kHeapThreads) {
    const int2 x = win[j];
    keys[w0 + j] = x.x;
    vals[w0 + j] = x.y;
    if constexpr (R) rid[w0 + j] = rwin[j];
  }
}

// The launch arguments of one call (the rider's are null / 0 without one;
// sel and shards are the grid's).
struct HeapArgs {
  int32_t *k, *v;
  const int32_t *si, *o, *ok_, *ov;
  int32_t *rk, *rv;
  uint8_t* a;
  int32_t* so;
  int b, cap_log2, max_depth;
  int32_t* rid;
  const int32_t* opr;
  int opr_stride;
  int32_t* outr;
  const int32_t* sel;
  int shards;
};

template <int A, bool R, int M>
int launch_heap(const HeapArgs& x, int arity_log2, cudaStream_t s) {
  static bool opted_in = false;  // one attribute call per instance
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        heap_apply_kernel<A, R, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<A, R>);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  heap_apply_kernel<A, R, M>
      <<<M == kOpsGiven ? 1 : x.shards, kHeapThreads, kSmemBytes<A, R>, s>>>(
          x.k, x.v, x.si, x.o, x.ok_, x.ov, x.rk, x.rv, x.a, x.so, x.b,
          x.cap_log2, x.max_depth, x.rid, x.opr, x.opr_stride, x.outr,
          x.sel, arity_log2);
  return static_cast<int>(cudaGetLastError());
}

template <bool R, int M>
int launch_arity(const HeapArgs& x, int arity_log2, cudaStream_t s) {
  switch (arity_log2) {
    case 1:
      return launch_heap<1, R, M>(x, 1, s);
    case 2:
      return launch_heap<2, R, M>(x, 2, s);
    case 3:
      return launch_heap<3, R, M>(x, 3, s);
    default:  // any arity above 8: the runtime-arity instance
      if (arity_log2 < 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch_heap<0, R, M>(x, arity_log2, s);
  }
}

template <int M>
int launch_grid(const HeapArgs& x, int arity_log2, cudaStream_t s) {
  return x.rid ? launch_arity<true, M>(x, arity_log2, s)
               : launch_arity<false, M>(x, arity_log2, s);
}

}  // namespace repro

// keys/vals: (2^cap_log2,) int32, updated in place; size_in: (1,) int32;
// ops/okeys/ovals: (b,) int32; outk/outv: (b,) int32; ok: (b,) bool;
// size_out: (1,) int32.  b > 0, 0 < cap_log2 <= 30, arity_log2 >= 1
// (1..3 with a shared-memory top, above that the runtime-arity instance),
// max_depth = ceil(cap_log2 / arity_log2) + 1.  One launch of one block
// with up to 217,768 B of dynamic shared memory.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without a
// launch, for arity_log2 < 1).
extern "C" int repro_heap_apply(void* keys, void* vals, const void* size_in,
                                const void* ops, const void* okeys,
                                const void* ovals, void* outk, void* outv,
                                void* ok, void* size_out, int b,
                                int cap_log2, int arity_log2, int max_depth,
                                void* stream) {
  using namespace repro;
  const HeapArgs x{static_cast<int32_t*>(keys),
                   static_cast<int32_t*>(vals),
                   static_cast<const int32_t*>(size_in),
                   static_cast<const int32_t*>(ops),
                   static_cast<const int32_t*>(okeys),
                   static_cast<const int32_t*>(ovals),
                   static_cast<int32_t*>(outk),
                   static_cast<int32_t*>(outv),
                   static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(size_out),
                   b, cap_log2, max_depth, nullptr, nullptr, 0, nullptr,
                   nullptr, 1};
  return launch_arity<false, kOpsGiven>(x, arity_log2,
                                        static_cast<cudaStream_t>(stream));
}

// The rider instance: as above, plus rider (2^cap_log2,) int32, updated in
// place; oprider: one int32 (opr_stride 0) or (b,) int32 (opr_stride 1),
// the rider INSERT lanes install; outr: (b,) int32, the popped riders.
// Up to 177,200 B of dynamic shared memory.
extern "C" int repro_heap_apply_rider(
    void* keys, void* vals, void* rider, const void* size_in,
    const void* ops, const void* okeys, const void* ovals,
    const void* oprider, void* outk, void* outv, void* outr, void* ok,
    void* size_out, int b, int cap_log2, int arity_log2, int max_depth,
    int opr_stride, void* stream) {
  using namespace repro;
  if (opr_stride != 0 && opr_stride != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const HeapArgs x{static_cast<int32_t*>(keys),
                   static_cast<int32_t*>(vals),
                   static_cast<const int32_t*>(size_in),
                   static_cast<const int32_t*>(ops),
                   static_cast<const int32_t*>(okeys),
                   static_cast<const int32_t*>(ovals),
                   static_cast<int32_t*>(outk),
                   static_cast<int32_t*>(outv),
                   static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(size_out),
                   b, cap_log2, max_depth, static_cast<int32_t*>(rider),
                   static_cast<const int32_t*>(oprider), opr_stride,
                   static_cast<int32_t*>(outr), nullptr, 1};
  return launch_arity<true, kOpsGiven>(x, arity_log2,
                                       static_cast<cudaStream_t>(stream));
}

// The shard grid: `shards` heaps stacked in keys / vals (and rider, when
// not null) as (shards, 2^cap_log2) int32, updated in place; sizes
// (shards,) int32, read and written in place.  mode 1 (pop count): sel is
// counts (shards,); block s pops min(counts[s], sizes[s]) roots, lanes
// [0, b) of row s of outk / outv / ok (and outr) (shards, b).  mode 2
// (masked insert): sel is dest (b,); okeys / ovals (b,), oprider one
// int32 (opr_stride 0) or (b,) (opr_stride 1); block s installs the lanes
// with dest == s in lane order; outk, outv, ok and outr are not used.
// One launch of `shards` blocks, each with the shared memory of
// repro_heap_apply (or of the rider instance).
extern "C" int repro_heap_apply_grid(
    void* keys, void* vals, void* rider, void* sizes, const void* sel,
    const void* okeys, const void* ovals, const void* oprider, void* outk,
    void* outv, void* outr, void* ok, int shards, int b, int cap_log2,
    int arity_log2, int max_depth, int mode, int opr_stride, void* stream) {
  using namespace repro;
  if ((opr_stride != 0 && opr_stride != 1) || shards < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const HeapArgs x{static_cast<int32_t*>(keys),
                   static_cast<int32_t*>(vals),
                   static_cast<const int32_t*>(sizes),
                   nullptr,
                   static_cast<const int32_t*>(okeys),
                   static_cast<const int32_t*>(ovals),
                   static_cast<int32_t*>(outk),
                   static_cast<int32_t*>(outv),
                   static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(sizes),
                   b, cap_log2, max_depth, static_cast<int32_t*>(rider),
                   static_cast<const int32_t*>(oprider), opr_stride,
                   static_cast<int32_t*>(outr),
                   static_cast<const int32_t*>(sel), shards};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPopCount:
      return launch_grid<kPopCount>(x, arity_log2, s);
    case kMaskedInsert:
      return launch_grid<kMaskedInsert>(x, arity_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Nodes of the shared-memory top (kResidentMax) for arity_log2 in 1..3,
// with the rider plane (rider != 0) or without; 0 above 3 (the
// runtime-arity instance keeps none), -1 below 1.  A host query: no
// launch.
extern "C" int repro_heap_resident_max(int arity_log2, int rider) {
  using namespace repro;
  if (arity_log2 > 3) return 0;
  switch (arity_log2) {
    case 1:
      return rider ? kResidentMax<1, true> : kResidentMax<1, false>;
    case 2:
      return rider ? kResidentMax<2, true> : kResidentMax<2, false>;
    case 3:
      return rider ? kResidentMax<3, true> : kResidentMax<3, false>;
    default:
      return -1;
  }
}
