// K9: one PMYULA (Moreau-Yosida unadjusted Langevin) sample of the
// deconvolution posterior exp(-||A x - y||^2 - G(x)) in a single kernel:
//
//     gw = 2 A^H A x - 2 atb                  (the adjoint taps carry the 2x)
//     x+ = c1 x - gamma gw + cp prox(x) + ns xi
//     m1+ = m1 + w x+,   m2+ = m2 + w x+ x+   (w: the collect weight, 0 or 1)
//
// with c1 = 1 - gamma/tau, cp = gamma/tau and ns = sqrt(2 gamma); prox is
// none (x+ = x - gamma gw + ns xi), the nonnegative projection, or the soft
// threshold at thr = tau lam.  xi is read from a given image (stream mode)
// or drawn in the kernel (prng mode): Philox4x32-10 keyed by (seed, n) with
// the pixel index as the counter, then Box-Muller on two 24-bit uniforms
// (u1 in (0, 1], so log never sees 0).  kernels/langevin.py normal_noise is
// the same generator in plain PyTorch.
//
// Replaces pycsou_tpu/kernels/langevin.py pmyula_mega_step
// (_pmyula_kernel).  The TPU kernel built the rank-1 Gram from a row band
// with edge corrections and a precomputed lane Gram, and drew its noise
// from the Mosaic PRNG, which has no counterpart here.  On the card each
// block owns a 32 x 32 tile and takes the exact Gram from gram_into
// (forward, then adjoint 'same' convolution: exact by the two-sweep
// argument, any rank <= 4; register-blocked passes with the taps, padded to
// K = 7, 15 or 31, in the kernel's parameters), then runs the per-pixel
// update.
//
// Bound by device-memory traffic: 7 image streams a sample in prng mode (x,
// atb, m1, m2 in; x+, m1+, m2+ out), 8 with a streamed xi; t = A x and gw
// stay in shared memory and registers.  (seed, n) and w come in by pointer
// from device tensors, so the host never waits on the card.  The outputs go
// to separate buffers (a block reads its neighbours' x).  The update is
// rounded as the plain version rounds it (no fused multiply-add).
#include <cstdint>

#include "sepconv.cuh"

namespace pct {

enum ProxMode { kProxNone = 0, kProxNonneg = 1, kProxL1 = 2 };

// Philox4x32-10 (Salmon et al., SC'11): ten rounds of two 32 x 32 -> 64-bit
// multiplies, with the Weyl key schedule between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Standard normal from the first two Philox words (Box-Muller on 24-bit
// uniforms, as the TPU kernel's _normal_from_bits does).
__device__ __forceinline__ float philox_normal(size_t idx, uint32_t seed, uint32_t n) {
  const uint4 b = philox4x32_10(make_uint4((uint32_t)idx, (uint32_t)(idx >> 32), 0u, 0u), seed, n);
  const float scale = 1.f / 16777216.f;
  const float u1 = 1.f - (float)(b.x >> 8) * scale;
  const float u2 = (float)(b.y >> 8) * scale;
  const float r = sqrtf(-2.f * logf(u1));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831855f, u2)));
}

template <int K>
__global__ void __launch_bounds__(kThreads, gram_min_blocks(K))
pmyula_kernel(const float* __restrict__ x, const float* __restrict__ atb,
              const float* __restrict__ m1, const float* __restrict__ m2,
              const float* __restrict__ noise, const int* __restrict__ si,
              const float* __restrict__ wf, float* __restrict__ xo, float* __restrict__ m1o,
              float* __restrict__ m2o, int H, int W, GramTaps<K> gt, float gamma, float c1, float cp,
              float ns, float thr, int prox_mode) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const Region G{smem, r0, c0, kTile, kTile, kTile + 1};
  gram_into<K>(x, H, W, gt, G, G.p + kTile * G.s);

  const uint32_t seed = (uint32_t)__ldg(si), n = (uint32_t)__ldg(si + 1);
  const float w = __ldg(wf);
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= H || c >= W) continue;
    const size_t k = (size_t)r * W + c;
    const float xj = __ldg(x + k);
    const float gw = __fsub_rn(G.p[(i / kTile) * G.s + i % kTile], __fmul_rn(2.f, __ldg(atb + k)));
    const float z = noise ? __ldg(noise + k) : philox_normal(k, seed, n);
    float xn;
    if (prox_mode == kProxNone) {
      xn = __fsub_rn(xj, __fmul_rn(gamma, gw));
    } else {
      float p;
      if (prox_mode == kProxNonneg) {
        p = fmaxf(xj, 0.f);
      } else {
        const float m = fmaxf(__fsub_rn(fabsf(xj), thr), 0.f);
        p = xj < 0.f ? -m : m;
      }
      xn = __fadd_rn(__fsub_rn(__fmul_rn(c1, xj), __fmul_rn(gamma, gw)), __fmul_rn(cp, p));
    }
    xn = __fadd_rn(xn, __fmul_rn(ns, z));
    const float wx = __fmul_rn(w, xn);
    xo[k] = xn;
    m1o[k] = __fadd_rn(__ldg(m1 + k), wx);
    m2o[k] = __fadd_rn(__ldg(m2 + k), __fmul_rn(wx, xn));
  }
}

}  // namespace pct

using namespace pct;

namespace {

template <int K>
int launch_pmyula(const float* x, const float* atb, const float* m1, const float* m2, const float* noise,
                  const int* si, const float* wf, float* xo, float* m1o, float* m2o, int H, int W,
                  const GramTaps<K>& gt, float gamma, float c1, float cp, float ns, float thr,
                  int prox_mode, cudaStream_t s) {
  const size_t floats = kTile * (kTile + 1) + gram_scratch_floats(kTile, kTile, K, gt.f.rank);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(pmyula_kernel<K>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  pmyula_kernel<K><<<grid, kThreads, bytes, s>>>(x, atb, m1, m2, noise, si, wf, xo, m1o, m2o, H, W, gt,
                                                 gamma, c1, cp, ns, thr, prox_mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// taps = [uf | vf | ua | va] in host memory, with the gradient's 2x already
// in ua; si = (seed, n) int32 and wf = (w,) float32 on the device; noise
// null draws xi in the kernel.
int pct_pmyula(const float* x, const float* atb, const float* m1, const float* m2,
               const float* noise, const int* si, const float* wf, float* xo, float* m1o,
               float* m2o, int H, int W, const float* taps, int rank, int Ku, int Kv, int ouf,
               int ovf, int oua, int ova, float gamma, float c1, float cp, float ns, float thr,
               int prox_mode, void* stream) {
#define CALL(K)                                                                                  \
  launch_pmyula<K>(x, atb, m1, m2, noise, si, wf, xo, m1o, m2o, H, W,                        \
                   gram_taps<K>(taps, rank, Ku, Kv, ouf, ovf, oua, ova), gamma, c1, cp, ns, thr, \
                   prox_mode, (cudaStream_t)stream)
  PCT_DISPATCH_TAPS(Ku, Kv, CALL)
#undef CALL
}

}  // extern "C"
