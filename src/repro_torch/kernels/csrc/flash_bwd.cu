// Flash attention backward for Hopper (sm_90a), bfloat16, hd 32, 64, 80,
// 112 and 128: dq, dk and dv of csrc/flash_wgmma.cu's forward from the row
// log-sum-exp it saved, recomputing each logits tile.
//
// Replaces no Pallas kernel: it is the counterpart of the reference's XLA
// backward src/repro/models/layers.py:_flash_core_bwd (the custom_vjp of
// _flash_core), which XLA fuses on the TPU.  q (B, H, Sq, hd), k/v (B, KV,
// Sk, hd), out and dout like q, lse float32 (B, H, Sq) in natural-log
// units; dq like q, dk/dv like k; every tensor read or written through its
// own (batch, head, position) strides with unit stride along hd.  q head h
// reads kv head h / (H / KV).  Positions run from 0 on both sides and Sq
// == Sk, so every row has a valid key (the diagonal).
//
// Three launches, no atomics (the gradients are the same from run to
// run):
// 1. dot:  D = rowsum(dout * out) in float32, a thread a row.
// 2. dkdv: a CTA of 4 warps per (batch, kv head, 64-key block); warp w
//    owns keys 16 w .. 16 w + 15.  K and V stay in shared memory; the CTA
//    walks the kv head's `rep` query heads and, for each, the query blocks
//    the mask lets reach its keys (BQ rows: 64, 32 at hd 112 and 128;
//    all of them without a causal mask or window), and
//    recomputes for each:
//      s = softcap(q . k * scale), masked with -1e30;  p = exp(s - lse);
//      dv += p^T dout;  dp = dout v^T;
//      ds = p (dp - D) (1 - tanh^2(raw / cap)) scale;  dk += ds^T q.
//    dk and dv accumulate in float32 registers and are written once, so
//    the sum over GQA's `rep` heads stays inside one CTA.
// 3. dq:   a CTA of 4 warps per (batch, head, 64-query block); it walks
//    the key blocks the mask lets its rows reach and recomputes s, p, dp
//    and ds as above: dq += ds k.
// The products are mma.sync.m16n8k16 (bf16 in, float32 accumulate) with
// operands brought from shared memory by ldmatrix (.trans where the
// product runs along a tile's rows); p and ds are rounded to bfloat16 as
// the A operands of their products, as the reference casts ds before its
// dq and dk products.  Tiles sit in shared memory in rows of hd + 8
// elements (120 at hd 112: 60 words, so eight rows start 28 words apart
// modulo 32), so the eight rows an ldmatrix reads fall in distinct banks.
// hd 112 is seven 16-column chunks for the products along hd (S, dp) and
// seven pairs of 8-column n-tiles for dk, dv and dq.
// Query (key) blocks wholly masked for a key (query) block are skipped:
// their p is exactly 0.  Under a causal mask the heaviest CTAs launch
// first.
//
// Bound: the five products, 2 Sq Sk hd operations each per head, half of
// them under a causal mask, at 989 TFLOP/s of dense bf16.  This first
// version loads each tile with plain 16-byte loads and no pipeline, and
// issues mma.sync, not wgmma: it stays well short of that bound
// (PERF.md, the flash_bwd row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

typedef __nv_bfloat16 bf16;

struct BwdParams {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* dsum;  // D, (B, H, Sq) contiguous
  bf16 *dq, *dk, *dv;
  // {q, k, v, out, dout, dq, dk, dv} x {batch, head, position}, elements
  long long st[8][3];
  int batch, heads, kv_heads, rep, sq, sk, causal, window;
  float scale, softcap;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

// --------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D (16 x 8, float32) += A (16 x 16, bf16, row) B (16 x 8, bf16, col).
// Accumulator: d0, d1 at row g, columns 2 t and 2 t + 1; d2, d3 at row
// g + 8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of columns 16 kk .. 16 kk + 15 of a 16-row accumulator
// held as n-tiles of 8 columns (the accumulator's layout is the A
// operand's, two n-tiles to a k-step).
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// A tile of ROWS x HD from rows [r0, r0 + ROWS) of a (rows, HD) matrix
// with row pitch `pitch` (elements) into shared memory at a pitch of
// HD + 8; rows at or past `limit` read as zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long pitch, int r0,
                                          int limit) {
  constexpr int kChunks = HD / 8, kLd = HD + 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * pitch + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// Shared-memory addresses a lane gives ldmatrix, for a tile at `base`
// (pitch HD + 8 elements):
// - a_addr: the A operand (16 rows from `row0`, k columns from `col0`,
//   rows of the tile are the product's rows): row lane % 16, column block
//   lane / 16;
// - b_addr: two n-tiles of B where the tile's rows are B's columns (n):
//   n rows from `row0` (lane / 16 picks the second n-tile), k columns
//   from `col0` (lane / 8 % 2 the second half);
// - bt_addr: two n-tiles of B where the tile's rows are B's rows (k), with
//   .trans: k rows from `row0` (lane / 8 % 2 the second half), n columns
//   from `col0` (lane / 16 the second n-tile).
template <int HD>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int row0, int col0,
                                           int lane) {
  return base + 2 * ((row0 + (lane & 15)) * (HD + 8) + col0 + (lane >> 4) * 8);
}
template <int HD>
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int row0, int col0,
                                           int lane) {
  return base + 2 * ((row0 + (lane >> 4) * 8 + (lane & 7)) * (HD + 8) + col0 +
                     ((lane >> 3) & 1) * 8);
}
template <int HD>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int row0, int col0,
                                            int lane) {
  return base + 2 * ((row0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * (HD + 8) +
                     col0 + (lane >> 4) * 8);
}

// One element of the recompute: the logit's capped value and its cap
// factor 1 - tanh^2, or false when the mask drops the (query, key) pair.
__device__ __forceinline__ bool logit(const BwdParams& p, float acc, int qi,
                                      int key, float* s, float* dfac) {
  bool ok = qi < p.sq && key < p.sk;
  if (p.causal) ok = ok && key <= qi;
  if (p.window > 0) ok = ok && key > qi - p.window;
  const float raw = acc * p.scale;
  if (p.softcap != 0.f) {
    const float th = tanhf(raw / p.softcap);
    *s = p.softcap * th;
    *dfac = 1.f - th * th;
  } else {
    *s = raw;
    *dfac = 1.f;
  }
  return ok;
}

// ----------------------------------------------------------------- dot

template <int HD>
__global__ void bwd_dot_kernel(const BwdParams p) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (row >= static_cast<long long>(p.batch) * p.heads * p.sq) return;
  const int i = static_cast<int>(row % p.sq);
  const long long bh = row / p.sq;
  const int h = static_cast<int>(bh % p.heads);
  const int b = static_cast<int>(bh / p.heads);
  const bf16* o = p.o + b * p.st[kO][0] + h * p.st[kO][1] + i * p.st[kO][2];
  const bf16* d = p.dout + b * p.st[kDO][0] + h * p.st[kDO][1] +
                  i * p.st[kDO][2];
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD; c += 8) {
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
  p.dsum[row] = acc;
}

// ---------------------------------------------------------------- dk dv

template <int HD>
struct DkdvLayout {
  static constexpr int kBK = 64;                    // keys per CTA
  static constexpr int kBQ = HD <= 80 ? 64 : 32;    // query rows a step
  static constexpr int kLd = HD + 8;
  static constexpr int kSmem =
      2 * (2 * kBK + 2 * kBQ) * kLd + 2 * 4 * kBQ;  // K, V, Q, dO; lse, D
};

template <int HD>
__global__ void __launch_bounds__(128)
    bwd_dkdv_kernel(const BwdParams p) {
  using L = DkdvLayout<HD>;
  constexpr int kBK = L::kBK, kBQ = L::kBQ, kLd = L::kLd;
  constexpr int kNT = kBQ / 8;   // n-tiles of s^T and dp^T
  constexpr int kDT = HD / 8;    // n-tiles of dk and dv
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kBK * kLd;
  bf16* qs = vs + kBK * kLd;
  bf16* dos = qs + kBQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBQ * kLd);
  float* d_s = lse_s + kBQ;
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs),
                 qs_a = smem_addr(qs), dos_a = smem_addr(dos);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int per = p.batch * p.kv_heads;
  const int kb = blockIdx.x / per;   // low key blocks, the heaviest, first
  const int kvh = (blockIdx.x % per) % p.kv_heads;
  const int b = (blockIdx.x % per) / p.kv_heads;
  const int k0 = kb * kBK;
  load_tile<HD, kBK>(ks, p.k + b * p.st[kK][0] + kvh * p.st[kK][1],
                     p.st[kK][2], k0, p.sk);
  load_tile<HD, kBK>(vs, p.v + b * p.st[kV][0] + kvh * p.st[kV][1],
                     p.st[kV][2], k0, p.sk);

  // the queries that can reach keys [k0, k0 + kBK)
  int qlo = 0, qhi = p.sq;
  if (p.causal) qlo = k0;
  if (p.window > 0) qhi = min(qhi, k0 + kBK - 1 + p.window);
  const int qb_lo = qlo / kBQ, qb_hi = qhi > qlo ? (qhi + kBQ - 1) / kBQ : 0;

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key0 = k0 + 16 * warp + g;  // this lane's rows: key0, key0 + 8

  for (int r = 0; r < p.rep; ++r) {
    const int h = kvh * p.rep + r;
    const bf16* qh = p.q + b * p.st[kQ][0] + h * p.st[kQ][1];
    const bf16* doh = p.dout + b * p.st[kDO][0] + h * p.st[kDO][1];
    const long long row_base =
        (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int qb = qb_lo; qb < qb_hi; ++qb) {
      const int q0 = qb * kBQ;
      __syncthreads();  // the previous step's tiles are no longer read
      load_tile<HD, kBQ>(qs, qh, p.st[kQ][2], q0, p.sq);
      load_tile<HD, kBQ>(dos, doh, p.st[kDO][2], q0, p.sq);
      if (threadIdx.x < kBQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < p.sq ? p.lse[row_base + qi] : 0.f;
        d_s[threadIdx.x] = qi < p.sq ? p.dsum[row_base + qi] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T and dp^T = V dO^T: the warp's 16 keys x kBQ queries
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, a_addr<HD>(ks_a, 16 * warp, 16 * kc, lane));
        ldsm_x4(av, a_addr<HD>(vs_a, 16 * warp, 16 * kc, lane));
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, b_addr<HD>(qs_a, 16 * np, 16 * kc, lane));
          ldsm_x4(bo, b_addr<HD>(dos_a, 16 * np, 16 * kc, lane));
          mma(s[2 * np], ak, bq[0], bq[1]);
          mma(s[2 * np + 1], ak, bq[2], bq[3]);
          mma(dp[2 * np], av, bo[0], bo[1]);
          mma(dp[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      // p^T into s, ds^T into dp
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int key = e < 2 ? key0 : key0 + 8;
          float sv, dfac;
          const bool ok = logit(p, s[j][e], q0 + col, key, &sv, &dfac);
          const float pv = ok ? __expf(sv - lse_s[col]) : 0.f;
          s[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - d_s[col]) * dfac * p.scale;
        }
      }
      // dv += p^T dO, dk += ds^T Q: k runs over the kBQ queries
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a<kNT>(pa, s, kk);
        acc_to_a<kNT>(da, dp, kk);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, bt_addr<HD>(dos_a, 16 * kk, 16 * np, lane));
          ldsm_x4_t(bq, bt_addr<HD>(qs_a, 16 * kk, 16 * np, lane));
          mma(dv[2 * np], pa, bo[0], bo[1]);
          mma(dv[2 * np + 1], pa, bo[2], bo[3]);
          mma(dk[2 * np], da, bq[0], bq[1]);
          mma(dk[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  bf16* dkb = p.dk + b * p.st[kDK][0] + kvh * p.st[kDK][1];
  bf16* dvb = p.dv + b * p.st[kDV][0] + kvh * p.st[kDV][1];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= p.sk) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * p.st[kDK][2] + col) =
          __floats2bfloat162_rn(dk[j][2 * half], dk[j][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * p.st[kDV][2] + col) =
          __floats2bfloat162_rn(dv[j][2 * half], dv[j][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------------- dq

template <int HD>
struct DqLayout {
  static constexpr int kBQ = 64, kBK = 64, kLd = HD + 8;
  static constexpr int kSmem = 2 * (2 * kBQ + 2 * kBK) * kLd;  // Q dO K V
};

template <int HD>
__global__ void __launch_bounds__(128) bwd_dq_kernel(const BwdParams p) {
  using L = DqLayout<HD>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kLd = L::kLd;
  constexpr int kNT = kBK / 8, kDT = HD / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kBQ * kLd;
  bf16* ks = dos + kBQ * kLd;
  bf16* vs = ks + kBK * kLd;
  const uint32_t qs_a = smem_addr(qs), dos_a = smem_addr(dos),
                 ks_a = smem_addr(ks), vs_a = smem_addr(vs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nqb = (p.sq + kBQ - 1) / kBQ;
  const int per = p.batch * p.heads;
  int qb = blockIdx.x / per;
  if (p.causal) qb = nqb - 1 - qb;   // the heaviest query blocks first
  const int h = (blockIdx.x % per) % p.heads;
  const int b = (blockIdx.x % per) / p.heads;
  const int kvh = h / p.rep;
  const int q0 = qb * kBQ;
  load_tile<HD, kBQ>(qs, p.q + b * p.st[kQ][0] + h * p.st[kQ][1],
                     p.st[kQ][2], q0, p.sq);
  load_tile<HD, kBQ>(dos, p.dout + b * p.st[kDO][0] + h * p.st[kDO][1],
                     p.st[kDO][2], q0, p.sq);
  const long long row_base =
      (static_cast<long long>(b) * p.heads + h) * p.sq;
  const int row0 = q0 + 16 * warp + g;  // this lane's rows: row0, row0 + 8
  float lse[2], dsum[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qi = row0 + 8 * x;
    lse[x] = qi < p.sq ? p.lse[row_base + qi] : 0.f;
    dsum[x] = qi < p.sq ? p.dsum[row_base + qi] : 0.f;
  }

  // the keys rows [q0, q0 + kBQ) can reach
  int klo = 0, khi = p.sk;
  if (p.causal) khi = min(khi, q0 + kBQ);
  if (p.window > 0) klo = max(0, q0 - p.window + 1);
  const int kb_lo = klo / kBK, kb_hi = khi > klo ? (khi + kBK - 1) / kBK : 0;

  float dq[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const bf16* kh = p.k + b * p.st[kK][0] + kvh * p.st[kK][1];
  const bf16* vh = p.v + b * p.st[kV][0] + kvh * p.st[kV][1];

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous key block is no longer read
    load_tile<HD, kBK>(ks, kh, p.st[kK][2], k0, p.sk);
    load_tile<HD, kBK>(vs, vh, p.st[kV][2], k0, p.sk);
    __syncthreads();

    // s = Q K^T and dp = dO V^T: the warp's 16 rows x kBK keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, a_addr<HD>(qs_a, 16 * warp, 16 * kc, lane));
      ldsm_x4(ao, a_addr<HD>(dos_a, 16 * warp, 16 * kc, lane));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, b_addr<HD>(ks_a, 16 * np, 16 * kc, lane));
        ldsm_x4(bv, b_addr<HD>(vs_a, 16 * np, 16 * kc, lane));
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ao, bv[0], bv[1]);
        mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // ds into dp
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float sv, dfac;
        const bool ok = logit(p, s[j][e], row0 + 8 * x, key, &sv, &dfac);
        const float pv = ok ? __expf(sv - lse[x]) : 0.f;
        dp[j][e] = pv * (dp[j][e] - dsum[x]) * dfac * p.scale;
      }
    }
    // dq += ds K: k runs over the kBK keys
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a<kNT>(da, dp, kk);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, bt_addr<HD>(ks_a, 16 * kk, 16 * np, lane));
        mma(dq[2 * np], da, bk[0], bk[1]);
        mma(dq[2 * np + 1], da, bk[2], bk[3]);
      }
    }
  }

  bf16* dqb = p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][1];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int qi = row0 + 8 * x;
      if (qi < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + qi * p.st[kDQ][2] + col) =
            __floats2bfloat162_rn(dq[j][2 * x], dq[j][2 * x + 1]);
    }
  }
}

// ----------------------------------------------------------------- host

template <int HD>
cudaError_t launch(const BwdParams& p, cudaStream_t s) {
  using LK = DkdvLayout<HD>;
  using LQ = DqLayout<HD>;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LK::kSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LQ::kSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const long long rows = static_cast<long long>(p.batch) * p.heads * p.sq;
  const long long dkdv_ctas = static_cast<long long>(
      (p.sk + LK::kBK - 1) / LK::kBK) * p.batch * p.kv_heads;
  const long long dq_ctas = static_cast<long long>(
      (p.sq + LQ::kBQ - 1) / LQ::kBQ) * p.batch * p.heads;
  if ((rows + 127) / 128 > 0x7fffffffLL || dkdv_ctas > 0x7fffffffLL ||
      dq_ctas > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bwd_dot_kernel<HD><<<static_cast<unsigned>((rows + 127) / 128), 128, 0,
                       s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_kernel<HD><<<static_cast<unsigned>(dkdv_ctas), 128, LK::kSmem,
                        s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<HD><<<static_cast<unsigned>(dq_ctas), 128, LQ::kSmem, s>>>(
      p);
  return cudaGetLastError();
}

}  // namespace repro

// q, k, v, o, dout: bfloat16 device pointers, 16-byte aligned; lse and
// dsum: float32 (B, H, Sq) contiguous (dsum receives D); dq, dk, dv:
// bfloat16 outputs.  dims: {B, H, KV, Sq, Sk, hd, causal, window};
// strides: {q, k, v, o, dout, dq, dk, dv} x {batch, head, position} in
// elements, each a multiple of 8 (unit stride along hd).  hd is 32, 64,
// 80, 112 or 128 and Sq == Sk; causal is 0 or 1.  Three launches: the D
// pass, dk/dv, dq.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// when the arguments are refused.
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
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
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
  p.sq = dims[3];
  p.sk = dims[4];
  p.causal = dims[6];
  p.window = dims[7];
  p.scale = scale;
  p.softcap = softcap;
  if (p.batch <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads || p.sq <= 0 || p.sq != p.sk)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rep = p.heads / p.kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    case 80: return launch<80>(p, s);
    case 112: return launch<112>(p, s);
    case 128: return launch<128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
