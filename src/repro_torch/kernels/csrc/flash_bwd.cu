// Flash attention backward for Hopper (sm_90a), bfloat16, hd 32, 64, 80,
// 112, 128 and 256: dq, dk and dv of csrc/flash_wgmma.cu's forward from
// the row log-sum-exp it saved, recomputing each logits tile; wgmma for
// every product, tiles brought in by TMA through an mbarrier ring,
// warp-specialised.
//
// Replaces no Pallas kernel: it is the counterpart of the reference's XLA
// backward src/repro/models/layers.py:_flash_core_bwd (the custom_vjp of
// _flash_core), which XLA fuses on the TPU.  q (B, H, S, hd), k/v (B, KV,
// S, hd), out and dout like q, lse float32 (B, H, S) in natural-log units;
// dq like q, dk/dv like k; every tensor read or written through its own
// (batch, head, position) strides with unit stride along hd (TMA reads q,
// k, v and dout as 4-D (hd, S, heads, B) maps, as the forward does).  q
// head h reads kv head h / (H / KV).  Positions run from 0 on both sides
// and Sq == Sk, so every row has a valid key (the diagonal).  Per element:
//   s = softcap(q . k * scale), p = exp(s - lse) (0 where masked);
//   D = rowsum(dout * out);  dp = dout . v;
//   ds = p (dp - D) (1 - tanh^2(raw / cap)) scale;
//   dv = sum p^T dout, dk = sum ds^T q, dq = sum ds k,
// with p and ds rounded to bfloat16 as the A operands of their products,
// as the reference casts them.
//
// Two launches, no atomics, so two calls on the same inputs give the same
// bits:
// 1. dq (first): a CTA per (batch, head, block of kBM query rows), one
//    consumer warpgroup per 64 rows and a producer warp.  Its prologue
//    brings the block's Q and dO in by TMA once, and computes D for its
//    rows from out and dout (two threads a row), keeping it and writing
//    it out for launch 2: the D pass of a three-launch design folds away.
//    The producer brings 64-key K and V tiles through a ring, only the
//    tiles the mask lets the block reach.  A tile: S = Q K^T and dP = dO
//    V^T as SS wgmma (m64n64); P and dS stay in registers, the
//    accumulator's layout being wgmma's A fragment; dQ += dS K as RS wgmma
//    (m64n{hd}, K an MN-major B operand), as the forward issues P V.  dq is
//    written once.
// 2. dk/dv: a CTA per (batch, kv head, block of kBK keys).  K and V come
//    in by TMA once and stay.  The producer walks the kv head's `rep`
//    query heads and, for each, the 64-row query blocks the mask lets
//    reach the keys, bringing Q, dO, and the rows' lse and D through the
//    ring.  A block: S^T = K Q^T and dP^T = V dO^T as SS wgmma with M =
//    the keys; P^T and dS^T stay in registers; dV += P^T dO and dK += dS^T
//    Q as RS wgmma (Q and dO MN-major).  The sum over GQA's `rep` heads
//    stays inside the CTA.
// That is seven products against the bound's five (S and dP are computed
// in both launches).  The five-product form, which accumulates dq across
// the key-block CTAs with float32 atomics (FlashAttention-3's), is left
// out on purpose: its sums land in a different order on every run.
//
// The CTAs are warp-specialised: consumer warpgroups of 64 rows each (of
// query rows in launch 1, of keys in launch 2) and a producer warpgroup
// whose first warp issues the loads and which hands its registers to the
// consumers (setmaxnreg).  Launch 1 runs three consumer warpgroups up to
// hd 80 (160 registers each), two at hd 112 and 128 (240), one at hd
// 256; launch 2 runs two (240).  Within a warpgroup a tile's two groups of
// products run one after the other (issue, wait, elementwise work, issue,
// wait); the warpgroups of a CTA hide each other's waits.  The elementwise
// step is straight-line code over a thread's 32 elements (the cap tested
// once a tile, the mask a second pass on the tiles it reaches): with a
// branch an element the elements' exp and FMA latencies did not overlap,
// and a call took 1.96 ms at danube's shape on the H100 where it takes
// 1.14 (tools/port_kernel_ab.py).  Tried there and left out: the forward's
// turn-taking
// between warpgroups, and the S and dP chains one after the other instead
// of interleaved (no change either way); issuing tile j + 1's S and dP
// with tile j's dQ (no gain, and the fragments twice); 128-key tiles in
// launch 1 (slower); three warpgroups with 32-row blocks in launch 2
// (slower at hd 32 and 64); three warpgroups in launch 1 at hd 112
// (registers short: spills, slower).  All but the first and the last
// were measured before the elementwise step was made straight-line.
//
// hd 256, the register budget: a 64-key block's dk and dv are 2 x 64 x
// 256 float32 accumulators, 256 registers a thread over one warpgroup.
// Launch 2 therefore splits them across its two warpgroups, which share
// the same 64 keys (kBK 64): warpgroup 0 computes S^T and P^T and holds
// dV; it passes p (1 - tanh^2) scale through shared memory (64 x 64
// float32, in accumulator order: thread i of the other warpgroup holds
// the same elements) to warpgroup 1, which computes dP^T and dS^T and
// holds dK; 128 accumulator registers each.  (The other split, the hd
// halves across warpgroups, would compute S^T and dP^T twice.)  Shared
// memory there: K and V 32 KB each, a stage of Q and dO 64 KB, two
// stages, P 16 KB: 210 KB of the 227 KB.  Launch 1 at hd 256 runs one
// warpgroup of 64 rows (dq 128 registers, S and dP 32 each): Q and dO 64
// KB and two 64 KB stages of K and V, 194 KB.
//
// Mask work: key tiles (query blocks) the mask leaves wholly empty for a
// CTA are never loaded; a warpgroup skips the products of a tile that is
// empty for its own rows; the mask is evaluated only on tiles that cross
// the diagonal, the window edge or S.  The heaviest CTAs launch first
// (launch 1: query blocks in reverse under a causal mask; launch 2: low
// key blocks first).
//
// Bound: the five products, 2 S^2 hd operations each per head (half of
// them under a causal mask, the window's pairs under a window), at 989
// TFLOP/s of dense bf16.  Times: PERF.md, the flash backward row.
#include "hopper.cuh"

namespace repro {

typedef __nv_bfloat16 bf16;

struct BwdParams {
  const bf16 *o, *dout;  // read with plain loads for D
  const float* lse;      // (B, H, S) contiguous
  float* dsum;           // D, (B, H, S) contiguous
  bf16 *dq, *dk, *dv;
  // {q, k, v, out, dout, dq, dk, dv} x {batch, head, position}, elements
  long long st[8][3];
  int batch, heads, kv_heads, rep, seq, causal, window;
  float scale, softcap;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

constexpr float kLog2e = 1.4426950408889634f;

// Launch 1.  kWGs consumer warpgroups of 64 query rows, 64-key tiles.
template <int HD>
struct DqLayout {
  using Bx = Boxes<HD>;
  // three warpgroups up to hd 80 (160 registers each: dq, S, dP and the
  // dS fragments fit), two at hd 112 and 128 (240), one at hd 256
  static constexpr int kWGs = HD <= 80 ? 3 : HD == 256 ? 1 : 2;
  static constexpr int kConsumerRegs = kWGs == 3 ? 160 : 240;
  static constexpr int kBM = 64 * kWGs;  // query rows a CTA
  static constexpr int kBN = 64;         // keys a tile
  static constexpr int kStages = HD == 256 ? 2 : 3;
  static constexpr int kThreads = 128 * kWGs + 128;
  static constexpr int kQBytes = Bx::kCount * kBM * Bx::kRowBytes;
  static constexpr int kTileBytes = Bx::kCount * kBN * Bx::kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  // Q, dO, the ring, D of the block's rows
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * kStageBytes +
                               4 * kBM;
};

// Launch 2.  Two consumer warpgroups: 64 keys each (kBK 128), or at hd
// 256 the same 64 keys split as above (kBK 64); 64-row query blocks.
template <int HD>
struct DkvLayout {
  using Bx = Boxes<HD>;
  static constexpr bool kSplit = HD == 256;
  static constexpr int kBK = kSplit ? 64 : 128;  // keys a CTA
  static constexpr int kBQ = 64;                 // query rows a block
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kThreads = 384;
  static constexpr int kKBytes = Bx::kCount * kBK * Bx::kRowBytes;
  static constexpr int kTileBytes = Bx::kCount * kBQ * Bx::kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // Q, then dO
  static constexpr int kPBytes = kSplit ? 64 * 64 * 4 : 0;
  static constexpr int kVecBytes = kStages * 2 * kBQ * 4;  // lse, D
  // K, V, the ring, P (split), each stage's lse (log2 units) and D
  static constexpr int kSmem = 1024 + 2 * kKBytes + kStages * kStageBytes +
                               kPBytes + kVecBytes;
};

// The key tiles [lo, hi) of kBN keys that query rows [q0, q0 + rows)
// reach under the mask.
template <int kBN>
__device__ __forceinline__ void key_tiles(const BwdParams& p, int q0,
                                          int rows, int* lo, int* hi) {
  const int q_last = min(q0 + rows, p.seq) - 1;
  *lo = 0;
  *hi = (p.seq + kBN - 1) / kBN;
  if (q_last < q0) {
    *hi = 0;
    return;
  }
  if (p.causal) *hi = min(*hi, q_last / kBN + 1);
  if (p.window > 0) *lo = max(0, q0 - p.window + 1) / kBN;
}

// The query blocks [lo, hi) of kBQ rows that reach keys [k0, k0 + keys).
template <int kBQ>
__device__ __forceinline__ void query_blocks(const BwdParams& p, int k0,
                                             int keys, int* lo, int* hi) {
  const int k_last = min(k0 + keys, p.seq) - 1;
  int qlo = 0, qhi = p.seq;
  if (k_last < k0) qhi = 0;
  if (p.causal) qlo = k0;
  if (p.window > 0) qhi = min(qhi, k_last + p.window);
  *lo = qlo / kBQ;
  *hi = qhi > qlo ? (qhi + kBQ - 1) / kBQ : *lo;
}

// Whether the mask can drop a pair of the 64 x 64 tile of query rows
// [q0, q0 + 64) and keys [k0, k0 + 64), or either side runs past S.
__device__ __forceinline__ bool tile_edge(const BwdParams& p, int q0,
                                          int k0) {
  return q0 + 64 > p.seq || k0 + 64 > p.seq ||
         (p.causal && k0 + 63 > q0) ||
         (p.window > 0 && k0 <= q0 + 63 - p.window);
}

__device__ __forceinline__ bool pair_ok(const BwdParams& p, int q, int key) {
  bool ok = q < p.seq && key < p.seq;
  if (p.causal) ok = ok && key <= q;
  if (p.window > 0) ok = ok && key > q - p.window;
  return ok;
}

// The recompute's constants: p = exp2(s * scale2 - lse2) without a cap;
// with one, th = tanh(s * scap), p = exp2(th * cap2 - lse2) and the cap
// factor (1 - th^2) scale.
struct Logit {
  float scale, scale2, scap, cap2;
  bool capped;
  __device__ __forceinline__ explicit Logit(const BwdParams& p)
      : scale(p.scale), scale2(p.scale * kLog2e),
        scap(p.softcap != 0.f ? p.scale / p.softcap : 0.f),
        cap2(p.softcap * kLog2e), capped(p.softcap != 0.f) {}
};

// The elementwise step on a 64-row tile of 32 accumulator registers a
// thread: S (or S^T) in sa becomes P and dP (or dP^T) in dp becomes dS,
// with lse2 (log2 units) and D of element r given by lse_of(r) and
// d_of(r).  Straight-line code over the tile (the cap tested once, not an
// element at a time), so the elements' latencies overlap; the mask is a
// second pass, on tiles it reaches, through masked(r).
template <class Lse, class D, class Masked>
__device__ __forceinline__ void tile_ds(const Logit& c, float (&sa)[32],
                                        float (&dp)[32], bool edge,
                                        Lse lse_of, D d_of,
                                        Masked masked) {
  if (c.capped) {
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float th = tanhf(sa[r] * c.scap);
      const float pv = exp2_ftz(th * c.cap2 - lse_of(r));
      dp[r] = pv * (dp[r] - d_of(r)) * ((1.f - th * th) * c.scale);
      sa[r] = pv;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float pv = exp2_ftz(sa[r] * c.scale2 - lse_of(r));
      dp[r] = pv * (dp[r] - d_of(r)) * c.scale;
      sa[r] = pv;
    }
  }
  if (edge) {
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (masked(r)) sa[r] = dp[r] = 0.f;
  }
}

// 64 x 64 S (or S^T) and dP (or dP^T) accumulators as bf16 A fragments,
// 16 columns a product.
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4],
                                         const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(c[8 * kk + 2 * x], c[8 * kk + 2 * x + 1]);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}
__device__ __forceinline__ void fence_all(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) fence_reg(a[kk][x]);
  }
}

// A 64-row accumulator of HD columns into rows [row0, row0 + 64) of a
// (rows, hd) bf16 matrix with row pitch `pitch`: register 4 j + e holds
// row g + 8 (e / 2) of warp w's 16, column 8 j + 2 t + e % 2.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long long pitch,
                                           const float (&acc)[HD / 2],
                                           int r0, int limit, int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = r0 + 8 * x;
      if (row < limit)
        *reinterpret_cast<__nv_bfloat162*>(dst + row * pitch + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * x], acc[4 * j + 2 * x + 1]);
    }
  }
}

// ------------------------------------------------------------------- dq

template <int HD>
__global__ void __launch_bounds__(DqLayout<HD>::kThreads, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const BwdParams p) {
  using L = DqLayout<HD>;
  using Bx = Boxes<HD>;
  constexpr int kStages = L::kStages, kWGs = L::kWGs;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t q_s = raw + pad, do_s = q_s + L::kQBytes;
  const uint32_t kv_s = do_s + L::kQBytes;  // stage s: K, then V
  float* d_s = reinterpret_cast<float*>(smem_raw + pad + 2 * L::kQBytes +
                                        kStages * L::kStageBytes);
  const uint32_t bar0 = smem_addr(bars);  // full[s], empty[s], then Q's
  const uint32_t q_bar = bar0 + 8 * 2 * kStages;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int n_qt = (p.seq + L::kBM - 1) / L::kBM;
  const int per = p.heads * p.batch;
  int qt = blockIdx.x / per;
  if (p.causal) qt = n_qt - 1 - qt;  // the heaviest blocks first
  const int h = (blockIdx.x % per) % p.heads;
  const int b = (blockIdx.x % per) / p.heads;
  const int q0 = qt * L::kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * s, 1);
      mbar_init(bar0 + 8 * (kStages + s), 4 * kWGs);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int lo, hi;
  key_tiles<L::kBN>(p, q0, L::kBM, &lo, &hi);

  if (warp >= 4 * kWGs) {
    // ---- producer warpgroup: one thread keeps the ring full
    if constexpr (kWGs > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * kWGs && lane == 0) {
      const int kvh = h / p.rep;
      mbar_expect_tx(q_bar, 2 * L::kQBytes);
      tma_rows<HD, L::kBM>(q_s, &tq, q_bar, q0, h, b);
      tma_rows<HD, L::kBM>(do_s, &tdo, q_bar, q0, h, b);
      for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
        const int s = i % kStages;
        const uint32_t full = bar0 + 8 * s, empty = bar0 + 8 * (kStages + s);
        if (i >= kStages) mbar_wait(empty, (i / kStages - 1) & 1);
        mbar_expect_tx(full, L::kStageBytes);
        const uint32_t dst = kv_s + s * L::kStageBytes;
        tma_rows<HD, L::kBN>(dst, &tk, full, kt * L::kBN, kvh, b);
        tma_rows<HD, L::kBN>(dst + L::kTileBytes, &tv, full, kt * L::kBN,
                             kvh, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64)
  if constexpr (kWGs > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     L::kConsumerRegs) : "memory");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x & 127;
  const int q0w = q0 + 64 * wg;
  const int r0 = q0w + 16 * (warp & 3) + g, r1 = r0 + 8;
  const long long row_base =
      (static_cast<long long>(b) * p.heads + h) * p.seq;

  // D = rowsum(dout * out) for the warpgroup's rows, two threads a row
  {
    const int row = q0w + (tid >> 1), half = tid & 1;
    float acc = 0.f;
    if (row < p.seq) {
      const bf16* o = p.o + b * p.st[kO][0] + h * p.st[kO][1] +
                      row * p.st[kO][2] + half * (HD / 2);
      const bf16* d = p.dout + b * p.st[kDO][0] + h * p.st[kDO][1] +
                      row * p.st[kDO][2] + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + c);
        const uint4 e = *reinterpret_cast<const uint4*>(d + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&e);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 fa = __bfloat1622float2(a2[x]);
          const float2 fe = __bfloat1622float2(e2[x]);
          acc += fa.x * fe.x + fa.y * fe.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_s[64 * wg + (tid >> 1)] = acc;
      if (row < p.seq) p.dsum[row_base + row] = acc;
    }
  }
  named_sync(1 + wg, 128);  // the warpgroup's D are in shared memory
  const float dr[2] = {d_s[r0 - q0], d_s[r1 - q0]};
  const float lse2[2] = {r0 < p.seq ? p.lse[row_base + r0] * kLog2e : 0.f,
                         r1 < p.seq ? p.lse[row_base + r1] * kLog2e : 0.f};
  const Logit lc(p);
  int wlo = 0, whi = 0;
  key_tiles<L::kBN>(p, q0w, 64, &wlo, &whi);

  float dq[HD / 2], sa[32], dp[32];
  uint32_t da[4][4];
  // every register a product reads or writes starts defined (else ptxas
  // serializes the products, C7515)
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) dq[r] = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) sa[r] = dp[r] = 0.f;
  to_frags(da, sa);
  mbar_wait(q_bar, 0);

  const int n = hi - lo;
  for (int i = 0; i < n; ++i) {
    const int kt = lo + i, s = i % kStages;
    const bool on = kt >= wlo && kt < whi;
    const uint32_t k_src = kv_s + s * L::kStageBytes;
    const uint32_t v_src = k_src + L::kTileBytes;
    mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
    wgmma_fence();
    if (on) {
      // S = Q K^T, dP = dO V^T: both K-major, 16 columns of hd a product,
      // the two chains interleaved
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        wgmma_ss_m64n64(sa, desc_kmajor<HD, L::kBM>(q_s, 64 * wg, kc),
                        desc_kmajor<HD, L::kBN>(k_src, 0, kc), kc > 0);
        wgmma_ss_m64n64(dp, desc_kmajor<HD, L::kBM>(do_s, 64 * wg, kc),
                        desc_kmajor<HD, L::kBN>(v_src, 0, kc), kc > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(sa);
    fence_all(dp);
    if (on) {
      // P in sa, dS in dp
      const int k0 = kt * L::kBN;
      tile_ds(lc, sa, dp, tile_edge(p, q0w, k0),
              [&](int r) { return lse2[(r >> 1) & 1]; },
              [&](int r) { return dr[(r >> 1) & 1]; },
              [&](int r) {
                return !pair_ok(p, (r & 2) ? r1 : r0,
                                k0 + 8 * (r >> 2) + 2 * t + (r & 1));
              });
      to_frags(da, dp);
    }
    // dQ += dS K: K is the MN-major B operand, 16 keys a product.  The
    // fences, commits and waits run on every tile, the products only where
    // the rows reach it (as the forward's), or ptxas serializes them
    wgmma_fence();
    if (on) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_hd<HD>(dq, da[kk], desc_mnmajor<HD, L::kBN>(k_src, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dq);
    fence_all(da);
    __syncwarp();  // tile i is no longer read
    if (lane == 0) mbar_arrive(bar0 + 8 * (kStages + s));
  }

  if (whi > wlo)
    store_rows<HD>(p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][1], p.st[kDQ][2],
                   dq, r0, p.seq, t);
}

// ---------------------------------------------------------------- dk dv

template <int HD>
__global__ void __launch_bounds__(DkvLayout<HD>::kThreads, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const BwdParams p) {
  using L = DkvLayout<HD>;
  constexpr int kStages = L::kStages, kBQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t k_s = raw + pad, v_s = k_s + L::kKBytes;
  const uint32_t st_s = v_s + L::kKBytes;  // stage s: Q, then dO
  float* pt_s = reinterpret_cast<float*>(smem_raw + pad + 2 * L::kKBytes +
                                         kStages * L::kStageBytes);
  float* vec_s = pt_s + L::kPBytes / 4;  // stage s: lse2[64], then D[64]
  const uint32_t bar0 = smem_addr(bars);  // full[s], empty[s], then K/V's
  const uint32_t kv_bar = bar0 + 8 * 2 * kStages;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int per = p.kv_heads * p.batch;
  const int kb = blockIdx.x / per;  // low key blocks, the heaviest, first
  const int kvh = (blockIdx.x % per) % p.kv_heads;
  const int b = (blockIdx.x % per) / p.kv_heads;
  const int k0 = kb * L::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar0 + 8 * (kStages + s), 8);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int qb_lo, qb_hi;
  query_blocks<kBQ>(p, k0, L::kBK, &qb_lo, &qb_hi);
  const int nb = qb_hi - qb_lo, n = p.rep * nb;

  if (warp >= 8) {
    // ---- producer warpgroup: its first warp fills the ring, lane 0
    // issuing the TMA loads, every lane two rows' lse and D
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * L::kKBytes);
        tma_rows<HD, L::kBK>(k_s, &tk, kv_bar, k0, kvh, b);
        tma_rows<HD, L::kBK>(v_s, &tv, kv_bar, k0, kvh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int h = kvh * p.rep + i / nb;
        const int qq0 = (qb_lo + i % nb) * kBQ;
        const int s = i % kStages;
        const uint32_t full = bar0 + 8 * s, empty = bar0 + 8 * (kStages + s);
        if (i >= kStages) mbar_wait(empty, (i / kStages - 1) & 1);
        const long long rb = (static_cast<long long>(b) * p.heads + h) * p.seq;
        float* vec = vec_s + s * 2 * kBQ;
        for (int x = lane; x < kBQ; x += 32) {
          const int qi = qq0 + x;
          vec[x] = qi < p.seq ? p.lse[rb + qi] * kLog2e : 0.f;
          vec[kBQ + x] = qi < p.seq ? p.dsum[rb + qi] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full, L::kStageBytes);
          const uint32_t dst = st_s + s * L::kStageBytes;
          tma_rows<HD, kBQ>(dst, &tq, full, qq0, h, b);
          tma_rows<HD, kBQ>(dst + L::kTileBytes, &tdo, full, qq0, h, b);
        } else {
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x & 127;
  const int kw0 = L::kSplit ? k0 : k0 + 64 * wg;  // the warpgroup's keys
  const int key0 = kw0 + 16 * (warp & 3) + g, key1 = key0 + 8;
  const Logit lc(p);
  int wlo, whi;
  query_blocks<kBQ>(p, kw0, 64, &wlo, &whi);
  // warpgroup 0's dV, or (split) warpgroup wg's dV (0) or dK (1)
  float acc0[HD / 2];
  // warpgroup's dK (joint)
  float acc1[L::kSplit ? 1 : HD / 2];
  float sa[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) acc0[r] = 0.f;
#pragma unroll
  for (int r = 0; r < (L::kSplit ? 1 : HD / 2); ++r) acc1[r] = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) sa[r] = dp[r] = 0.f;
  to_frags(pa, sa);
  to_frags(da, sa);
  mbar_wait(kv_bar, 0);

  if constexpr (!L::kSplit) {
    // each warpgroup: its 64 keys, all four products
    for (int i = 0; i < n; ++i) {
      const int qq0 = (qb_lo + i % nb) * kBQ, s = i % kStages;
      const bool on = qb_lo + i % nb >= wlo && qb_lo + i % nb < whi;
      const uint32_t q_src = st_s + s * L::kStageBytes;
      const uint32_t do_src = q_src + L::kTileBytes;
      mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
      wgmma_fence();
      if (on) {
        // S^T = K Q^T, dP^T = V dO^T: K-major both sides, M = the keys
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) {
          wgmma_ss_m64n64(sa, desc_kmajor<HD, L::kBK>(k_s, 64 * wg, kc),
                          desc_kmajor<HD, kBQ>(q_src, 0, kc), kc > 0);
          wgmma_ss_m64n64(dp, desc_kmajor<HD, L::kBK>(v_s, 64 * wg, kc),
                          desc_kmajor<HD, kBQ>(do_src, 0, kc), kc > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(sa);
      fence_all(dp);
      if (on) {
        // P^T in sa, dS^T in dp; lse and D are a column's (a query's)
        const float* lse2 = vec_s + s * 2 * kBQ;
        const float* dd = lse2 + kBQ;
        auto col = [t](int r) { return 8 * (r >> 2) + 2 * t + (r & 1); };
        tile_ds(lc, sa, dp, tile_edge(p, qq0, kw0),
                [&](int r) { return lse2[col(r)]; },
                [&](int r) { return dd[col(r)]; },
                [&](int r) {
                  return !pair_ok(p, qq0 + col(r), (r & 2) ? key1 : key0);
                });
        to_frags(pa, sa);
        to_frags(da, dp);
      }
      // dV += P^T dO, dK += dS^T Q: dO and Q MN-major, 16 rows each
      wgmma_fence();
      if (on) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_hd<HD>(acc0, pa[kk], desc_mnmajor<HD, kBQ>(do_src, kk), 1);
          wgmma_rs_hd<HD>(acc1, da[kk], desc_mnmajor<HD, kBQ>(q_src, kk), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc0);
      fence_all(acc1);
      fence_all(pa);
      fence_all(da);
      __syncwarp();  // block i is no longer read
      if (lane == 0) mbar_arrive(bar0 + 8 * (kStages + s));
    }
    bf16* dkb = p.dk + b * p.st[kDK][0] + kvh * p.st[kDK][1];
    bf16* dvb = p.dv + b * p.st[kDV][0] + kvh * p.st[kDV][1];
    if (whi > wlo) {
      store_rows<HD>(dvb, p.st[kDV][2], acc0, key0, p.seq, t);
      store_rows<HD>(dkb, p.st[kDK][2], acc1, key0, p.seq, t);
    }
  } else {
    // hd 256: warpgroup 0 S^T, P^T and dV; warpgroup 1 dP^T, dS^T and dK,
    // each through the same code on its own operands (K and Q, or V and
    // dO; dO or Q as the second product's B).  Named barrier 3: warpgroup
    // 1 has read the last P (it may be overwritten); 4: warpgroup 0 has
    // written this block's.
    const uint32_t a_s = wg == 0 ? k_s : v_s;
    for (int i = 0; i < n; ++i) {
      const int qq0 = (qb_lo + i % nb) * kBQ, s = i % kStages;
      const uint32_t q_src = st_s + s * L::kStageBytes;
      const uint32_t do_src = q_src + L::kTileBytes;
      const uint32_t b1 = wg == 0 ? q_src : do_src;
      const uint32_t b2 = wg == 0 ? do_src : q_src;
      const float* lse2 = vec_s + s * 2 * kBQ;
      const float* dd = lse2 + kBQ;
      mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        wgmma_ss_m64n64(sa, desc_kmajor<HD, L::kBK>(a_s, 0, kc),
                        desc_kmajor<HD, kBQ>(b1, 0, kc), kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(sa);
      if (wg == 0) {
        // P^T into sa; to warpgroup 1 p (1 - tanh^2) scale, which tile_ds
        // leaves in dp from dp = 1 and D = 0
        auto col = [t](int r) { return 8 * (r >> 2) + 2 * t + (r & 1); };
#pragma unroll
        for (int r = 0; r < 32; ++r) dp[r] = 1.f;
        tile_ds(lc, sa, dp, tile_edge(p, qq0, kw0),
                [&](int r) { return lse2[col(r)]; }, [](int) { return 0.f; },
                [&](int r) {
                  return !pair_ok(p, qq0 + col(r), (r & 2) ? key1 : key0);
                });
        if (i > 0) named_sync(3, 256);
#pragma unroll
        for (int r = 0; r < 32; ++r) pt_s[r * 128 + tid] = dp[r];
        named_arrive(4, 256);
      } else {
        // dS^T into sa (which holds dP^T)
        named_sync(4, 256);
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int col = 8 * (r >> 2) + 2 * t + (r & 1);
          sa[r] = pt_s[r * 128 + tid] * (sa[r] - dd[col]);
        }
        if (i < n - 1) named_arrive(3, 256);
      }
      to_frags(pa, sa);
      // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_hd<HD>(acc0, pa[kk], desc_mnmajor<HD, kBQ>(b2, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc0);
      fence_all(pa);
      __syncwarp();  // block i is no longer read
      if (lane == 0) mbar_arrive(bar0 + 8 * (kStages + s));
    }
    if (whi > wlo) {
      if (wg == 0)
        store_rows<HD>(p.dv + b * p.st[kDV][0] + kvh * p.st[kDV][1],
                       p.st[kDV][2], acc0, key0, p.seq, t);
      else
        store_rows<HD>(p.dk + b * p.st[kDK][0] + kvh * p.st[kDK][1],
                       p.st[kDK][2], acc0, key0, p.seq, t);
    }
  }
}

// ----------------------------------------------------------------- host

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long* strides, const BwdParams& p,
                   cudaStream_t s) {
  using LQ = DqLayout<HD>;
  using LK = DkvLayout<HD>;
  // every map in boxes of 64 rows: a tile of 128 rows is two boxes
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_map<HD>(&tq, q, p.seq, p.heads, p.batch, strides + 3 * kQ,
                      64) ||
      !encode_map<HD>(&tdo, p.dout, p.seq, p.heads, p.batch,
                      strides + 3 * kDO, 64) ||
      !encode_map<HD>(&tk, k, p.seq, p.kv_heads, p.batch, strides + 3 * kK,
                      64) ||
      !encode_map<HD>(&tv, v, p.seq, p.kv_heads, p.batch, strides + 3 * kV,
                      64))
    return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LQ::kSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LK::kSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const long long dq_ctas = static_cast<long long>(
      (p.seq + LQ::kBM - 1) / LQ::kBM) * p.batch * p.heads;
  const long long dkdv_ctas = static_cast<long long>(
      (p.seq + LK::kBK - 1) / LK::kBK) * p.batch * p.kv_heads;
  if (dq_ctas > 0x7fffffffLL || dkdv_ctas > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bwd_dq_kernel<HD><<<static_cast<unsigned>(dq_ctas), LQ::kThreads,
                      LQ::kSmem, s>>>(tq, tdo, tk, tv, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_kernel<HD><<<static_cast<unsigned>(dkdv_ctas), LK::kThreads,
                        LK::kSmem, s>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace repro

// q, k, v, o, dout: bfloat16 device pointers, 16-byte aligned; lse and
// dsum: float32 (B, H, Sq) contiguous (dsum receives D); dq, dk, dv:
// bfloat16 outputs.  dims: {B, H, KV, Sq, Sk, hd, causal, window};
// strides: {q, k, v, o, dout, dq, dk, dv} x {batch, head, position} in
// elements, each a multiple of 8 (unit stride along hd).  hd is 32, 64,
// 80, 112, 128 or 256 and Sq == Sk; causal is 0 or 1.  Two launches: dq
// (which also writes D), then dk/dv.  Returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue when the arguments or a tensor
// map are refused.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dsum, void* dq, void* dk,
                                         void* dv, const int* dims,
                                         const long long* strides,
                                         float scale, float softcap,
                                         void* stream) {
  using namespace repro;
  BwdParams p;
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<float*>(dsum);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.batch = dims[0];
  p.heads = dims[1];
  p.kv_heads = dims[2];
  p.seq = dims[3];
  p.causal = dims[6];
  p.window = dims[7];
  p.scale = scale;
  p.softcap = softcap;
  if (p.batch <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads || p.seq <= 0 || dims[4] != p.seq)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rep = p.heads / p.kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 32: return launch<32>(q, k, v, strides, p, s);
    case 64: return launch<64>(q, k, v, strides, p, s);
    case 80: return launch<80>(q, k, v, strides, p, s);
    case 112: return launch<112>(q, k, v, strides, p, s);
    case 128: return launch<128>(q, k, v, strides, p, s);
    case 256: return launch<256>(q, k, v, strides, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
