// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py:_flash_kernel.
// q (B, H, Sq, hd), k/v (B, KV, Sk, hd), out like q; q head h reads kv head
// h / (H / KV) (GQA).  Every tensor is read through its own (batch, head,
// position) strides in elements, with unit stride along hd, so the model's
// (B, S, H, hd) activations need no transpose.
//
// Numerics follow the Pallas body: s = (q . k) * 1/sqrt(hd) in fp32; then
// cap * tanh(s / cap) when cap != 0; then masked keys get -1e30 (causal
// keeps kpos <= qpos, a window keeps kpos > qpos - window); an online
// softmax with m from -inf, p = exp(s - m_new), corr = exp(m - m_new),
// l = l * corr + sum(p), acc = acc * corr + p . v with p cast to v's type
// first; at the end out = acc / max(l, 1e-30) in v's type.  Positions
// beyond Sk (a ragged last key tile) get -inf, so they weigh exactly 0.
//
// The TPU kernel carried (m, l, acc) in VMEM across the sequential key
// grid dimension of 512 x 512 tiles.  Here one CTA owns a tile of query
// rows and loops over key tiles itself, keeping m, l and acc in
// registers.  Key tiles wholly above the causal diagonal or wholly before
// the window of every row of the CTA are skipped when Sq <= Sk (then
// every row keeps its own position, so it has a valid key): the Pallas
// kernel's contribution from such a tile is exactly zero once
// corr = exp(-1e30 - m) underflows.
//
// bf16: 4 warps, 64 query rows (16 per warp), key tiles of 64 staged in
// shared memory.  S = Q K^T and P V run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the S accumulator
// fragment is exactly P's A-operand fragment, so P never leaves
// registers.  f32: scalar FMAs, one thread per query row, key tiles of
// 32, hd up to 64.
//
// Bound: at the prefill shape (B 2, H 24, KV 8, S 4096, hd 64, causal)
// operations, 4 B H S^2 hd / 2 = 1.03e11 flop over the 989 TFLOP/s dense
// bf16 rate, 104 us; its bytes (q, k, v in, out out: 67 MB) take 20 us.
// This first kernel uses mma.sync, not wgmma/TMA, with no pipelining of
// the key tiles: far from that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, position strides
  int heads, kv_heads, sq, sk, rep, causal, window, skip;
  float scale, softcap;
};

constexpr float kMasked = -1e30f;

__device__ __forceinline__ float logit(float dot, const FlashParams& p,
                                       int qpos, int kpos) {
  if (kpos >= p.sk) return -INFINITY;  // padding of a ragged key tile
  float s = dot * p.scale;
  if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
  bool ok = true;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok ? s : kMasked;
}

// The key tiles [lo, hi) a CTA of query rows [q0, q0 + rows) must visit.
__device__ __forceinline__ void key_range(const FlashParams& p, int q0,
                                          int rows, int tile, int* lo,
                                          int* hi) {
  const int nk = (p.sk + tile - 1) / tile;
  *lo = 0;
  *hi = nk;
  if (!p.skip) return;
  const int q_last = min(q0 + rows - 1, p.sq - 1);
  if (p.causal) *hi = min(nk, q_last / tile + 1);
  if (p.window > 0) {
    const int first_valid = q0 - p.window + 1;
    if (first_valid > 0) *lo = first_valid / tile;
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kRows = 64;   // query rows per CTA (16 per warp)
constexpr int kKeys = 64;   // keys per tile
constexpr int kThreads = 128;
constexpr int kPad = 8;     // bf16 padding per shared row (16 bytes)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage rows [k0, k0 + kKeys) of a (positions, HD) bf16 slice into
// shared memory, zero past the end.
template <int HD>
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16 (*dst)[HD + kPad], const __nv_bfloat16* src,
    long long pos_stride, int k0, int sk) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kKeys * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k0 + r < sk)
      val = *reinterpret_cast<const uint4*>(src + (k0 + r) * pos_stride +
                                            col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const FlashParams p) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int kKc = HD / 16;    // k-chunks of Q K^T
  constexpr int kDn = HD / 8;     // n-tiles of P V
  constexpr int kSn = kKeys / 8;  // n-tiles of S
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys][HD + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeys][HD + kPad];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / p.rep;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.qs[0] + h * p.qs[1];
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.ks[0] + kvh * p.ks[1];
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.vs[0] + kvh * p.vs[1];
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;  // this thread's rows

  // Q as A fragments, one set of four registers per k-chunk
  uint32_t qa[kKc][4];
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kc * 16 + half * 8 + 2 * t;
      qa[kc][2 * half] =
          r_lo < p.sq ? *reinterpret_cast<const uint32_t*>(
                            qb + r_lo * p.qs[2] + col)
                      : 0u;
      qa[kc][2 * half + 1] =
          r_hi < p.sq ? *reinterpret_cast<const uint32_t*>(
                            qb + r_hi * p.qs[2] + col)
                      : 0u;
    }
  }

  float acc[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int kt_lo, kt_hi;
  key_range(p, q0, kRows, kKeys, &kt_lo, &kt_hi);
  const unsigned short* vsh = reinterpret_cast<const unsigned short*>(vs);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile is no longer read
    stage_tile<HD>(ks, kb, p.ks[2], k0, p.sk);
    stage_tile<HD>(vs, vb, p.vs[2], k0, p.sk);
    __syncthreads();

    float s[kSn][4];
#pragma unroll
    for (int j = 0; j < kSn; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            &ks[j * 8 + g][kc * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &ks[j * 8 + g][kc * 16 + 8 + 2 * t]);
        mma_bf16(s[j], qa[kc][0], qa[kc][1], qa[kc][2], qa[kc][3], b0, b1);
      }
    }

    // scale, cap, mask; the tile's row maxima (rows r_lo and r_hi)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? r_lo : r_hi;
        s[j][e] = logit(s[j][e], p, qpos, kpos);
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kSn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        rsum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * corr[r] + rsum[r];
    }
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // acc += bf16(P) V, 16 keys per mma: P's A fragment is S's C fragment
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t b0 =
            vsh[key * (HD + kPad) + col] |
            (static_cast<uint32_t>(vsh[(key + 1) * (HD + kPad) + col]) << 16);
        const uint32_t b1 =
            vsh[(key + 8) * (HD + kPad) + col] |
            (static_cast<uint32_t>(vsh[(key + 9) * (HD + kPad) + col]) << 16);
        mma_bf16(acc[dn], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] +
                      h * p.os[1];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r_lo < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_lo * p.os[2] + col) =
          __floats2bfloat162_rn(acc[dn][0] / fmaxf(l[0], 1e-30f),
                                acc[dn][1] / fmaxf(l[0], 1e-30f));
    if (r_hi < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_hi * p.os[2] + col) =
          __floats2bfloat162_rn(acc[dn][2] / fmaxf(l[1], 1e-30f),
                                acc[dn][3] / fmaxf(l[1], 1e-30f));
  }
}

// ----------------------------------------------------------------- f32

constexpr int kRowsF = 64;  // query rows per CTA, one per thread
constexpr int kKeysF = 32;  // keys per tile
// A thread keeps its query row, its accumulator and a tile of logits in
// registers: up to hd 64 that fits without spilling (the float32 path
// serves the reference's float32 kernel tests, whose hd is 32 or 64).
constexpr int kMaxHdF32 = 64;

template <int HD>
__global__ void __launch_bounds__(kRowsF)
    flash_f32_kernel(const FlashParams p) {
  __shared__ float ks[kKeysF][HD];
  __shared__ float vs[kKeysF][HD];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRowsF;
  const int kvh = h / p.rep;
  const int row = q0 + threadIdx.x;
  const float* qb = static_cast<const float*>(p.q) + b * p.qs[0] +
                    h * p.qs[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.ks[0] +
                    kvh * p.ks[1];
  const float* vb = static_cast<const float*>(p.v) + b * p.vs[0] +
                    kvh * p.vs[1];
  float q[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = row < p.sq ? qb[row * p.qs[2] + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int kt_lo, kt_hi;
  key_range(p, q0, kRowsF, kKeysF, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kKeysF;
    __syncthreads();
    for (int c = threadIdx.x; c < kKeysF * HD; c += kRowsF) {
      const int r = c / HD, d = c % HD;
      const bool in = k0 + r < p.sk;
      ks[r][d] = in ? kb[(k0 + r) * p.ks[2] + d] : 0.f;
      vs[r][d] = in ? vb[(k0 + r) * p.vs[2] + d] : 0.f;
    }
    __syncthreads();
    float s[kKeysF];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysF; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(q[d], ks[j][d], dot);
      s[j] = logit(dot, p, row, k0 + j);
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    m = m_new;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysF; ++j) {
      s[j] = expf(s[j] - m);
      rsum += s[j];
    }
    l = l * corr + rsum;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      float a = acc[d] * corr;
#pragma unroll
      for (int j = 0; j < kKeysF; ++j) a = fmaf(s[j], vs[j][d], a);
      acc[d] = a;
    }
  }
  if (row >= p.sq) return;
  float* ob = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[1] +
              row * p.os[2];
  const float lf = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < HD; ++d) ob[d] = acc[d] / lf;
}

template <int HD>
cudaError_t launch(const FlashParams& p, int batch, bool bf16,
                   cudaStream_t s) {
  if (bf16) {
    dim3 grid((p.sq + kRows - 1) / kRows, p.heads, batch);
    flash_bf16_kernel<HD><<<grid, kThreads, 0, s>>>(p);
  } else if constexpr (HD <= kMaxHdF32) {
    dim3 grid((p.sq + kRowsF - 1) / kRowsF, p.heads, batch);
    flash_f32_kernel<HD><<<grid, kRowsF, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace repro

// q, k, v, o: device pointers.  dims: {B, H, KV, Sq, Sk, hd, causal,
// window, bf16}; strides: {q, k, v, o} x {batch, head, position}, in
// elements (unit stride along hd).  bf16 != 0 for bfloat16 tensors, 0 for
// float32.  hd is 32, 64, 80 or 128 in bfloat16, 32 or 64 in float32.
// scale is the reference's
// 1 / sqrt(hd) rounded to float32.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const int* dims,
                                     const long long* strides, float scale,
                                     float softcap, void* stream) {
  using namespace repro;
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  const int batch = dims[0], hd = dims[5];
  p.heads = dims[1];
  p.kv_heads = dims[2];
  p.sq = dims[3];
  p.sk = dims[4];
  p.causal = dims[6];
  p.window = dims[7];
  const bool bf16 = dims[8] != 0;
  if (batch <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads || p.sq <= 0 || p.sk <= 0 || batch > 65535 ||
      p.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rep = p.heads / p.kv_heads;
  p.skip = p.sq <= p.sk;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return static_cast<int>(launch<32>(p, batch, bf16, s));
    case 64: return static_cast<int>(launch<64>(p, batch, bf16, s));
    case 80: return static_cast<int>(launch<80>(p, batch, bf16, s));
    case 128: return static_cast<int>(launch<128>(p, batch, bf16, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
