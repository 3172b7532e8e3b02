// Flash attention forward for Hopper (sm_90a), float32: the twin of the
// reference's float32 kernel tests.  bfloat16, the model's type, runs
// csrc/flash_wgmma.cu (wgmma and TMA); kernels/flash_attn.py dispatches
// by dtype.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py:_flash_kernel
// in float32.  q (B, H, Sq, hd), k/v (B, KV, Sk, hd), out like q; q head h
// reads kv head h / (H / KV) (GQA).  Every tensor is read through its own
// (batch, head, position) strides in elements, with unit stride along hd.
//
// Numerics follow the Pallas body: s = (q . k) * 1/sqrt(hd) in fp32; then
// cap * tanh(s / cap) when cap != 0; then masked keys get -1e30 (causal
// keeps kpos <= qpos, a window keeps kpos > qpos - window); an online
// softmax with m from -inf, p = exp(s - m_new), corr = exp(m - m_new),
// l = l * corr + sum(p), acc = acc * corr + p . v; at the end out =
// acc / max(l, 1e-30).  Positions beyond Sk (a ragged last key tile) get
// -inf, so they weigh exactly 0.
//
// The TPU kernel carried (m, l, acc) in VMEM across the sequential key
// grid dimension of 512 x 512 tiles.  Here one CTA owns 64 query rows
// and loops over key tiles of 32 staged in dynamic shared memory, keeping
// m, l and acc in registers (scalar FMAs).  At hd 32 and 64 a row is one
// thread; at hd 80, 112, 128 and 256 a row is four neighbouring lanes,
// each holding a quarter of q and acc (20, 28, 32 or 64 floats), which sum
// their partial dot products with two shuffles.  Key tiles wholly above
// the causal diagonal or wholly before the window of every row of the CTA
// are skipped when Sq <= Sk (then every row keeps its own position, so it
// has a valid key): the Pallas kernel's contribution from such a tile is
// exactly zero once corr = exp(-1e30 - m) underflows.
//
// Bound: operations, at 67 TFLOP/s of float32 outside the tensor cores.
// It serves tests only and is not timed.
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

constexpr int kRowsF = 64;  // query rows per CTA
constexpr int kKeysF = 32;  // keys per tile
// A thread keeps its share of the query row and of the accumulator and a
// tile of logits in registers: whole rows up to hd 64, quarter rows above
// (64 + 64 + 32 floats at hd 256).
template <int HD>
constexpr int kLanesPerRow = HD <= 64 ? 1 : 4;
template <int HD>
constexpr int kSmemF = 2 * kKeysF * HD * static_cast<int>(sizeof(float));

template <int HD>
__global__ void __launch_bounds__(kRowsF * kLanesPerRow<HD>)
    flash_f32_kernel(const FlashParams p) {
  constexpr int R = kLanesPerRow<HD>;  // lanes per query row
  constexpr int DP = HD / R;           // dims a lane holds
  constexpr int kThreads = kRowsF * R;
  extern __shared__ float smem_f[];
  float(*ks)[HD] = reinterpret_cast<float(*)[HD]>(smem_f);
  float(*vs)[HD] = reinterpret_cast<float(*)[HD]>(smem_f + kKeysF * HD);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRowsF;
  const int kvh = h / p.rep;
  const int row = q0 + static_cast<int>(threadIdx.x) / R;
  const int d0 = (static_cast<int>(threadIdx.x) % R) * DP;
  const float* qb = static_cast<const float*>(p.q) + b * p.qs[0] +
                    h * p.qs[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.ks[0] +
                    kvh * p.ks[1];
  const float* vb = static_cast<const float*>(p.v) + b * p.vs[0] +
                    kvh * p.vs[1];
  float q[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    q[d] = row < p.sq ? qb[row * p.qs[2] + d0 + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int kt_lo, kt_hi;
  key_range(p, q0, kRowsF, kKeysF, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kKeysF;
    __syncthreads();
    for (int c = threadIdx.x; c < kKeysF * HD; c += kThreads) {
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
      for (int d = 0; d < DP; ++d) dot = fmaf(q[d], ks[j][d0 + d], dot);
#pragma unroll
      for (int off = 1; off < R; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
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
    for (int d = 0; d < DP; ++d) {
      float a = acc[d] * corr;
#pragma unroll
      for (int j = 0; j < kKeysF; ++j) a = fmaf(s[j], vs[j][d0 + d], a);
      acc[d] = a;
    }
  }
  if (row >= p.sq) return;
  float* ob = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[1] +
              row * p.os[2];
  const float lf = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DP; ++d) ob[d0 + d] = acc[d] / lf;
}

template <int HD>
cudaError_t launch(const FlashParams& p, int batch, cudaStream_t s) {
  static bool sized = false;  // one attribute call per instance
  if (!sized && kSmemF<HD> > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemF<HD>);
    if (e != cudaSuccess) return e;
  }
  sized = true;
  dim3 grid((p.sq + kRowsF - 1) / kRowsF, p.heads, batch);
  flash_f32_kernel<HD><<<grid, kRowsF * kLanesPerRow<HD>, kSmemF<HD>, s>>>(
      p);
  return cudaGetLastError();
}

}  // namespace repro

// q, k, v, o: device pointers.  dims: {B, H, KV, Sq, Sk, hd, causal,
// window, bf16}; strides: {q, k, v, o} x {batch, head, position}, in
// elements (unit stride along hd).  float32 only: bf16 must be 0 (bfloat16
// goes to flash_wgmma.cu).  hd is 32, 64, 80, 112, 128 or 256.  scale is
// the reference's 1 / sqrt(hd) rounded to float32.  Returns cudaGetLastError() after the
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
  if (dims[8] != 0 || batch <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads || p.sq <= 0 || p.sk <= 0 || batch > 65535 ||
      p.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rep = p.heads / p.kv_heads;
  p.skip = p.sq <= p.sk;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return static_cast<int>(launch<32>(p, batch, s));
    case 64: return static_cast<int>(launch<64>(p, batch, s));
    case 80: return static_cast<int>(launch<80>(p, batch, s));
    case 112: return static_cast<int>(launch<112>(p, batch, s));
    case 128: return static_cast<int>(launch<128>(p, batch, s));
    case 256: return static_cast<int>(launch<256>(p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
