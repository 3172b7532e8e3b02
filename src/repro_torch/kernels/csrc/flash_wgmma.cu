// Flash attention forward for Hopper (sm_90a), bfloat16, hd 32, 64, 80,
// 112, 128 and 256: wgmma for both products, K/V brought in by TMA into an
// mbarrier-tracked ring in shared memory, warp-specialised.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py:_flash_kernel
// in bfloat16 (float32, for tests, runs csrc/flash_attn.cu).  q (B, H, Sq, hd), k/v
// (B, KV, Sk, hd), out like q, each read through its own (batch, head,
// position) strides with unit stride along hd; q head h reads kv head
// h / (H / KV).  The numerics are the Pallas body's:
// s = (q . k) * scale in float32 (scale after the product, never folded
// into a bf16 q), cap * tanh(s / cap) when cap != 0, -1e30 on masked keys,
// -inf past Sk, an online softmax from m = -inf, P cast to bf16 before
// P V, out = acc / max(l, 1e-30).  Two liberties, both far inside the
// card's check (chip_smoke.py: FLASH_TOL): the exponentials are exp2 on
// the special-function unit with log2(e) folded into the scale (results
// below 2^-126 flush to 0), and the divisions are __fdividef (2 ulp).
// Given an lse buffer, the epilogue also writes each row's log-sum-exp,
// (m + log2 l) ln 2, the statistic the backward (csrc/flash_bwd.cu) needs:
// one float a row from the first lane of each quad.
//
// CTA: one per SM.  Three consumer warpgroups of 64 query rows each at
// hd <= 64 (192 rows a CTA), two at hd 80, 112, 128 and 256 (128 rows), and a
// producer warpgroup, which hands its registers to the consumers
// (setmaxnreg) and whose first thread issues every TMA load.  Q is loaded
// once.  K and V tiles of 128 keys sit in a ring of 3 stages
// (512 bytes of K and V per unit of hd: 32 KB at hd 64, 64 KB at hd
// 128); at hd 256 tiles of 64 keys in a ring of 2 (64 KB a stage), each
// with a full barrier (the producer's expect_tx; TMA
// completes it) and an empty barrier (one arrival per consumer warp).
// TMA reads the tensors as 4-D (hd, S, heads, B) through their own
// strides, so the model's (B, S, H, hd) activations need no copy, in
// boxes of a tile's rows swizzled at their row width (Layout below): 64
// columns with the 128-byte swizzle at hd 64, 128 and 256, 32 columns with the
// 64-byte swizzle at hd 32, 16 columns with the 32-byte swizzle at hd 80
// and 112 (160- and 224-byte rows: five and seven boxes).  The tensor maps
// are encoded on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda).
//
// S = Q K^T: wgmma m64n128k16 (m64n64k16 at hd 256), Q and K both
// K-major from shared memory
// (descriptors with the boxes' swizzle).  The S accumulator is
// laid out as wgmma's A fragment, so P is converted to bf16 in registers
// and P V runs as wgmma m64n{hd}k16 with A from registers and V from
// shared memory as an MN-major B operand (transpose bit set).  Step j of
// a warpgroup issues S of tile j and P V of tile j - 1 together, then
// does tile j's softmax; the warpgroups take turns to issue (named
// barriers), so one's softmax runs while another's products do.  The
// mask and the ragged-edge test run only on tiles that cross the
// diagonal, the window edge or Sk; key tiles wholly masked for a
// warpgroup's rows are skipped when Sq <= Sk (their contribution is
// exactly zero, as in flash_attn.cu).  Under a causal mask the CTAs are
// launched heaviest first (query tiles in reverse).
//
// Bound: at the prefill shape (B 2, H 24, KV 8, S 4096, hd 64, causal)
// 4 B H hd per (query, key) pair below the diagonal, 1.03e11 flop, is
// 104.25 us at 989 TFLOP/s dense bf16; its bytes (67 MB) take 20 us.
// Measured there (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, 700.00
// W): 260.87 us, against 257.91 us for PyTorch's
// scaled_dot_product_attention; at hd 128 (q (1, 32, 4096, 128), kv 8,
// causal) 267.98 us against 248.67 us and a 139.00 us bound; at hd 112
// (zamba2-7b's shared block: q (2, 32, 4096, 112), kv 32, causal) 636.37 us
// against 466.53 us and a 243.25 us bound; unmasked at hd 80
// (hubert-xlarge: q (2, 16, 4096, 80), kv 16) 408.24 us against 416.28 us
// and a 173.71 us bound.  The mma.sync kernel this replaces took 1,657.31
// us at the prefill shape.
// What this design leaves between it and the bound: every CTA reads its
// K and V tiles from L2 on its own, and at two or three warpgroups a
// CTA those reads set the pace of the products (sharing them through TMA
// multicast across a cluster of the CTAs of one kv head was tried and
// ran slower: a cluster's CTAs wait on each other's releases); the
// softmax's instructions are only partly hidden behind the other
// warpgroups' products; there is no persistent grid; the epilogue
// stores straight from registers.
#include "hopper.cuh"

namespace repro {

struct FlashParams {
  void* o;
  float* lse;       // (B, H, Sq) row log-sum-exp, natural log; may be null
  long long os[3];  // out: batch, head, position strides (elements)
  int heads, rep, sq, sk, causal, window, skip, n_qtiles;
  float scale, softcap;
};

constexpr float kMasked = -1e30f;

// The CTA: kWGs consumer warpgroups of 64 query rows each, then a
// producer warpgroup.  Three consumers at hd <= 64, where a K/V tile is
// cheap to compute on and the reads of K and V from L2 set the pace (the
// more rows share a tile, the fewer bytes a product needs); two at hd 80,
// 112, 128 and 256, whose accumulators leave no registers for a third.  The
// producer gives its registers to the consumers (setmaxnreg).
//
// Key tiles are kBN = 128 keys, but 64 at hd 256: there a consumer holds
// o[128] (the P V accumulator, m64n256), and S over 128 keys (64 more
// registers, and 32 for P) would pass its 240; and a stage of 128 keys
// of K and V would be 128 KB, so the ring could not hold two beside Q.
// At hd 256 the ring has two stages: 1 KB + Q's 64 KB + 2 x 64 KB = 193
// KB of the 227 KB.
//
// A tile of rows (kBM query rows, or kBN keys) by hd columns is kBoxes
// TMA boxes side by side, each kBoxCols columns wide and swizzled at its
// row width: hd 64, 128 and 256 in boxes of 64 columns (128-byte rows,
// the 128-byte swizzle), hd 32 in one box of 32 (64 bytes), hd 80 and 112
// in five and seven boxes of 16 (32 bytes).  The swizzle repeats every 8
// rows.  At hd 112 a stage is 2 x 7 boxes of 4 KB: 1 KB + Q's 28 KB + 3 x
// 56 KB = 197 KB of the 227 KB.
template <int HD>
struct Layout {
  static constexpr int kWGs = HD <= 64 ? 3 : 2;
  static constexpr int kBM = 64 * kWGs;  // query rows per CTA
  static constexpr int kBN = HD == 256 ? 64 : 128;  // keys per tile
  static constexpr int kSRegs = kBN / 2;  // S accumulator registers
  static constexpr int kPSteps = kBN / 16;  // P V products, 16 keys each
  static constexpr int kConsumerWarps = 4 * kWGs;
  static constexpr int kThreads = 32 * kConsumerWarps + 128;
  // registers a thread: the launch splits 65,536 evenly; the producer
  // keeps 24 and the consumers take the rest, a multiple of 8
  static constexpr int kConsumerRegs = kWGs == 3 ? 160 : 240;
  static constexpr int kBoxCols = Boxes<HD>::kCols;
  static constexpr int kBoxes = Boxes<HD>::kCount;
  static constexpr int kRowBytes = Boxes<HD>::kRowBytes;
  static constexpr int kBoxBytes = kBN * kRowBytes;  // kBN keys
  static constexpr int kQBoxBytes = kBM * kRowBytes;
  static constexpr int kStages = HD == 256 ? 2 : 3;
  static constexpr int kQBytes = kBoxes * kQBoxBytes;    // kBM rows
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // kBN keys
  static constexpr int kStageBytes = 2 * kTileBytes;     // K then V
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes;
};

// The key tiles [lo, hi) that query rows [q0, q0 + rows) must visit:
// tiles wholly above the causal diagonal or before the window of every
// row are left out when Sq <= Sk (then every row has a valid key).
template <int kBN>
__device__ __forceinline__ void key_range(const FlashParams& p, int q0,
                                          int rows, int* lo, int* hi) {
  const int nk = (p.sk + kBN - 1) / kBN;
  *lo = 0;
  *hi = nk;
  if (!p.skip) return;
  const int q_last = min(q0 + rows - 1, p.sq - 1);
  if (p.causal) *hi = min(nk, q_last / kBN + 1);
  if (p.window > 0) {
    const int first_valid = q0 - p.window + 1;
    if (first_valid > 0) *lo = first_valid / kBN;
  }
}

// -1e30 on masked keys and -inf past Sk, on a tile that crosses the
// diagonal, the window edge or Sk.  Register 4 j + e of S holds row
// (e < 2 ? r0 : r1) and key k0 + 8 j + 2 t + (e & 1).
template <int R>
__device__ __forceinline__ void mask_tile(float (&s)[R],
                                          const FlashParams& p, int k0,
                                          int r0, int r1, int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + 8 * j + 2 * t + (e & 1);
      const int qpos = e < 2 ? r0 : r1;
      bool ok = true;
      if (p.causal) ok = kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      s[4 * j + e] = kpos >= p.sk ? -INFINITY : (ok ? s[4 * j + e] : kMasked);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FlashParams p, int batch) {
  using L = Layout<HD>;
  constexpr int kStages = L::kStages;
  constexpr int kBN = L::kBN;
  constexpr int kS = L::kSRegs;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  // 1024-byte aligned: the 128-byte swizzle repeats every 8 rows of 128 B
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t kv_s = q_s + L::kQBytes;  // stage s: K, then V
  const uint32_t bar0 = smem_addr(bars);   // full[s], empty[s], then Q's
  const uint32_t q_bar = bar0 + 8 * 2 * kStages;

  // the warp index read from lane 0, so the compiler knows it is the same
  // across the warp (and every branch on it, around wgmma, uniform)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  // the CTA's (query tile, head, batch): heads vary fastest, so the heads
  // of one kv head run together; heaviest tiles first under a causal mask
  const int per_tile = p.heads * batch;
  int qt = blockIdx.x / per_tile;
  if (p.causal) qt = p.n_qtiles - 1 - qt;
  const int h = (blockIdx.x % per_tile) % p.heads;
  const int b = (blockIdx.x % per_tile) / p.heads;
  const int q0 = qt * L::kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * s, 1);
      mbar_init(bar0 + 8 * (kStages + s), L::kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int lo, hi;
  key_range<kBN>(p, q0, L::kBM, &lo, &hi);

  if (warp >= L::kConsumerWarps) {
    // ---- producer warpgroup: gives its registers to the consumers; one
    // thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == L::kConsumerWarps && lane == 0) {
      const int kvh = h / p.rep;
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(q_s + c * L::kQBoxBytes, &tq, q_bar, L::kBoxCols * c,
                    q0, h, b);
      for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
        const int s = i % kStages;
        const uint32_t full = bar0 + 8 * s, empty = bar0 + 8 * (kStages + s);
        if (i >= kStages) mbar_wait(empty, (i / kStages - 1) & 1);
        mbar_expect_tx(full, L::kStageBytes);
        const uint32_t k_dst = kv_s + s * L::kStageBytes;
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(k_dst + c * L::kBoxBytes, &tk, full, L::kBoxCols * c,
                      kt * kBN, kvh, b);
          tma_load_4d(k_dst + L::kTileBytes + c * L::kBoxBytes, &tv, full,
                      L::kBoxCols * c, kt * kBN, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs)
               : "memory");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int q0w = q0 + 64 * wg;
  const int r0 = q0w + 16 * (warp & 3) + g, r1 = r0 + 8;
  const int row_last = min(q0w + 63, p.sq - 1);
  int wlo = 0, whi = 0;
  if (q0w < p.sq) key_range<kBN>(p, q0w, 64, &wlo, &whi);
  // logits in log2 units: exp2f(s2 - m2) with s2 = s * log2(e)
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = p.softcap != 0.f ? p.scale : p.scale * kLog2e;

  float o[HD / 2], sa[kS];
  uint32_t pa[L::kPSteps][4];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) o[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kS; ++r) sa[r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < L::kPSteps; ++kk)
    pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  // Step j issues S of tile j and P V of tile j - 1 together, then does
  // tile j's softmax.  The warpgroups take turns to issue, in order
  // (warpgroup w waits on named barrier 1 + w and hands over to the
  // next), so one's softmax runs while another's products do.  The last
  // warpgroup lets warpgroup 0 go first and skips its last hand-over, so
  // each barrier sees as many arrivals as waits.
  const int next = 1 + (wg + 1) % L::kWGs;
  if (wg == L::kWGs - 1) named_arrive(1, 256);
  const int n = hi - lo;
  for (int j = 0; j <= n; ++j) {
    const int kt = lo + j;
    const bool s_on = j < n && kt >= wlo && kt < whi;
    const bool pv_on = j > 0 && kt - 1 >= wlo && kt - 1 < whi;
    const int s = j % kStages, sp = (j + kStages - 1) % kStages;
    if (j < n) mbar_wait(bar0 + 8 * s, (j / kStages) & 1);
    named_sync(1 + wg, 256);
    wgmma_fence();
    if (s_on) {
      // S = Q K^T, both K-major, 16 columns of hd per product
      const uint32_t k_src = kv_s + s * L::kStageBytes;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        const uint64_t dq = desc_kmajor<HD, L::kBM>(q_s, 64 * wg, kc);
        const uint64_t dk = desc_kmajor<HD, kBN>(k_src, 0, kc);
        if constexpr (kBN == 64)
          wgmma_ss_m64n64(sa, dq, dk, kc > 0);
        else
          wgmma_ss_m64n128(sa, dq, dk, kc > 0);
      }
    }
    if (pv_on) {
      // O += P V, V the MN-major B operand (hd contiguous), 16 keys a
      // product
      const uint32_t v_src = kv_s + sp * L::kStageBytes + L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < L::kPSteps; ++kk)
        wgmma_rs_hd<HD>(o, pa[kk], desc_mnmajor<HD, kBN>(v_src, kk), 1);
    }
    wgmma_commit();
    if (wg != L::kWGs - 1 || j < n) named_arrive(next, 256);
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kS; ++r) fence_reg(sa[r]);
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) fence_reg(o[r]);
#pragma unroll
    for (int kk = 0; kk < L::kPSteps; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) fence_reg(pa[kk][x]);
    }
    if (j > 0) {  // tile j - 1 is no longer read
      __syncwarp();
      if (lane == 0) mbar_arrive(bar0 + 8 * (kStages + sp));
    }
    if (!s_on) continue;

    // scale after the product, cap, then mask only where a mask reaches
    const int k0 = kt * kBN;
#pragma unroll
    for (int r = 0; r < kS; ++r) sa[r] *= scale2;
    if (p.softcap != 0.f) {
#pragma unroll
      for (int r = 0; r < kS; ++r)
        sa[r] = p.softcap * tanhf(__fdividef(sa[r], p.softcap)) * kLog2e;
    }
    const bool edge = k0 + kBN > p.sk || (p.causal && k0 + kBN - 1 > q0w) ||
                      (p.window > 0 && k0 <= row_last - p.window);
    if (edge) mask_tile(sa, p, k0, r0, r1, t);

    // online softmax over the tile; a row lives in the 4 lanes of a quad
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int r = 0; r < kS; ++r)
      tmax[(r >> 1) & 1] = fmaxf(tmax[(r >> 1) & 1], sa[r]);
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 1));
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 2));
      const float m_new = fmaxf(m[x], tmax[x]);
      corr[x] = exp2_ftz(m[x] - m_new);
      m[x] = m_new;
    }
#pragma unroll
    for (int r = 0; r < kS; ++r) {
      sa[r] = exp2_ftz(sa[r] - m[(r >> 1) & 1]);
      rsum[(r >> 1) & 1] += sa[r];
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rsum[x] += __shfl_xor_sync(0xffffffffu, rsum[x], 1);
      rsum[x] += __shfl_xor_sync(0xffffffffu, rsum[x], 2);
      l[x] = l[x] * corr[x] + rsum[x];
    }
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) o[r] *= corr[(r >> 1) & 1];
    // P in bf16 as wgmma's A fragments: 16 keys per product
#pragma unroll
    for (int kk = 0; kk < L::kPSteps; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sa[8 * kk + 2 * x], sa[8 * kk + 2 * x + 1]);
    }
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] +
                      h * p.os[1];
  if (p.lse != nullptr && t == 0) {
    // the row statistic the backward recomputes P from: m and l are in
    // log2 units (the exp2 scaling), every lane of a quad holds its row's
    float* lb = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
    constexpr float kLn2 = 0.6931471805599453f;
    if (r0 < p.sq) lb[r0] = (m[0] + log2f(l[0])) * kLn2;
    if (r1 < p.sq) lb[r1] = (m[1] + log2f(l[1])) * kLn2;
  }
  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.os[2] + col) =
          __floats2bfloat162_rn(__fdividef(o[4 * j], l0),
                                __fdividef(o[4 * j + 1], l0));
    if (r1 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.os[2] + col) =
          __floats2bfloat162_rn(__fdividef(o[4 * j + 2], l1),
                                __fdividef(o[4 * j + 3], l1));
  }
}

// ----------------------------------------------------------------- host

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long* strides, FlashParams p, int kv_heads,
                   int batch, cudaStream_t s) {
  using L = Layout<HD>;
  p.n_qtiles = (p.sq + L::kBM - 1) / L::kBM;
  CUtensorMap tq, tk, tv;
  if (!encode_map<HD>(&tq, q, p.sq, p.heads, batch, strides, L::kBM) ||
      !encode_map<HD>(&tk, k, p.sk, kv_heads, batch, strides + 3,
                      L::kBN) ||
      !encode_map<HD>(&tv, v, p.sk, kv_heads, batch, strides + 6, L::kBN))
    return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const long long ctas = static_cast<long long>(p.n_qtiles) * p.heads * batch;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_wgmma_kernel<HD><<<static_cast<unsigned>(ctas), L::kThreads,
                           L::kSmem, s>>>(tq, tk, tv, p, batch);
  return cudaGetLastError();
}

}  // namespace repro

// q, k, v, o: device pointers, bfloat16, 16-byte aligned; lse: null, or
// a float32 (B, H, Sq) contiguous buffer that receives each row's
// log-sum-exp of its (capped, masked) logits in natural-log units, the
// statistic the backward (csrc/flash_bwd.cu) recomputes P from.  dims: {B, H,
// KV, Sq, Sk, hd, causal, window, bf16}; strides: {q, k, v, o} x {batch,
// head, position} in elements, each a multiple of 8 (unit stride along
// hd).  hd is 32, 64, 80, 112, 128 or 256 and bf16 must be nonzero.
// scale is the reference's 1 / sqrt(hd) rounded to float32.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue when the
// arguments or a tensor map are refused.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* lse, const int* dims,
                                           const long long* strides,
                                           float scale, float softcap,
                                           void* stream) {
  using namespace repro;
  const int batch = dims[0], heads = dims[1], kv_heads = dims[2];
  const int sq = dims[3], sk = dims[4], hd = dims[5];
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads ||
      sq <= 0 || sk <= 0 || dims[8] == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.heads = heads;
  p.rep = heads / kv_heads;
  p.sq = sq;
  p.sk = sk;
  p.causal = dims[6];
  p.window = dims[7];
  p.skip = sq <= sk;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, strides, p, kv_heads, batch, s);
    case 64: return launch<64>(q, k, v, strides, p, kv_heads, batch, s);
    case 80: return launch<80>(q, k, v, strides, p, kv_heads, batch, s);
    case 112: return launch<112>(q, k, v, strides, p, kv_heads, batch, s);
    case 128: return launch<128>(q, k, v, strides, p, kv_heads, batch, s);
    case 256: return launch<256>(q, k, v, strides, p, kv_heads, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
