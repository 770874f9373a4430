// K8: one FISTA (APGD) iteration of the LASSO min ||A x - y||^2 + lam ||x||_1
// for a rank <= 4 PSF in a single kernel:
//
//     g  = 2 A^H A v - 2 atb          (the adjoint taps carry the 2x)
//     x+ = prox_{tau lam |.|_1}(v - tau g)   soft threshold at thr = tau lam,
//                                            or max(u - thr, 0) when nonneg
//     v+ = x+ + a (x+ - x_prev)       a = mom[0], the momentum coefficient
//
// with the stopping-metric partial sums [|x+ - x_prev|^2, |x_prev|^2,
// |v+ - v|^2, |v|^2, 0, 0] (the 6-lane layout of the TV kernels, so the
// same stats_fold adds them up).
//
// Replaces pycsou_tpu/kernels/fista.py lasso_fista_step (_fista_kernel).
// The TPU kernel ran a 3-stage VMEM ring over an ordered grid; here each
// block owns a 32 x 32 output tile, forms the exact Gram on it with
// gram_into (forward then adjoint 'same' convolution, register-blocked
// passes with the taps, padded to K = 7, 15 or 31, in the kernel's
// parameters; t = A v stays in shared memory) and runs the per-pixel
// epilogue.  The epilogue needs no halo: v is read over the Gram's reach
// only.
//
// Bound by device-memory traffic: 5 image streams an iteration (v, atb,
// x_prev in; x+, v+ out).  The momentum changes every iteration (BT and CD
// rules), so it comes in by pointer from a one-element device tensor: no
// host float, no sync.  The outputs go to buffers separate from the inputs:
// a block reads its neighbours' v, so updating in place (as the TPU kernel
// did on its ordered grid) would race.  g and u are rounded as the plain
// version rounds them (no fused multiply-add).
#include "sepconv.cuh"
#include "pds_stencil.cuh"  // Stats6, block_stats, stats_fold

namespace pct {

template <int K>
__global__ void __launch_bounds__(kThreads, gram_min_blocks(K))
lasso_fista_kernel(const float* __restrict__ v, const float* __restrict__ xp,
                   const float* __restrict__ atb, const float* __restrict__ mom,
                   float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ partials,
                   int H, int W, GramTaps<K> gt, float tau, float thr, int nonneg) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const Region G{smem, r0, c0, kTile, kTile, kTile + 1};
  gram_into<K>(v, H, W, gt, G, G.p + kTile * G.s);

  const float a = __ldg(mom);
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= H || c >= W) continue;
    const size_t k = (size_t)r * W + c;
    const float vv = __ldg(v + k), xpv = __ldg(xp + k);
    const float g = __fsub_rn(G.p[(i / kTile) * G.s + i % kTile], __fmul_rn(2.f, __ldg(atb + k)));
    const float u = __fsub_rn(vv, __fmul_rn(tau, g));
    float xn;
    if (nonneg) {
      xn = fmaxf(__fsub_rn(u, thr), 0.f);
    } else {
      const float m = fmaxf(__fsub_rn(fabsf(u), thr), 0.f);
      xn = u < 0.f ? -m : m;
    }
    const float vn = __fadd_rn(xn, __fmul_rn(a, __fsub_rn(xn, xpv)));
    xo[k] = xn;
    vo[k] = vn;
    const float dx = xn - xpv, dv = vn - vv;
    st.s[0] = fmaf(dx, dx, st.s[0]);
    st.s[1] = fmaf(xpv, xpv, st.s[1]);
    st.s[2] = fmaf(dv, dv, st.s[2]);
    st.s[3] = fmaf(vv, vv, st.s[3]);
  }
  block_stats(st, partials);
}

}  // namespace pct

using namespace pct;

namespace {

template <int K>
int launch_lasso_fista(const float* v, const float* xp, const float* atb, const float* mom, float* xo,
                       float* vo, float* partials, float* stats, int H, int W, const GramTaps<K>& gt,
                       float tau, float thr, int nonneg, cudaStream_t s) {
  const size_t floats = kTile * (kTile + 1) + gram_scratch_floats(kTile, kTile, K, gt.f.rank);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(lasso_fista_kernel<K>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  lasso_fista_kernel<K><<<grid, kThreads, bytes, s>>>(v, xp, atb, mom, xo, vo, partials, H, W, gt, tau,
                                                      thr, nonneg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// taps = [uf | vf | ua | va] in host memory, with the gradient's 2x already
// in ua; mom is a one-float device buffer; stats (6,) receives the folded
// partial sums.
int pct_lasso_fista(const float* v, const float* xp, const float* atb, const float* mom, float* xo,
                    float* vo, float* partials, float* stats, int H, int W, const float* taps,
                    int rank, int Ku, int Kv, int ouf, int ovf, int oua, int ova, float tau,
                    float thr, int nonneg, void* stream) {
#define CALL(K)                                                                                     \
  launch_lasso_fista<K>(v, xp, atb, mom, xo, vo, partials, stats, H, W,                         \
                        gram_taps<K>(taps, rank, Ku, Kv, ouf, ovf, oua, ova), tau, thr, nonneg, \
                        (cudaStream_t)stream)
  PCT_DISPATCH_TAPS(Ku, Kv, CALL)
#undef CALL
}

}  // extern "C"
