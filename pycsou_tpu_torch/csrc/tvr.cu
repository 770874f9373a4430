// K4: one full TV primal-dual iteration for a rank <= 4 PSF in a single
// kernel: forward convolution, adjoint convolution (2x folded into the
// adjoint row taps), the stencil of K3, and the metric partial sums.
// K7 is the same kernel instantiated with Masked: the data mask m
// multiplies t = A x after the 'same' crop, so the Gram is A^H diag(m) A
// (blurred, partially sampled data).
//
// Replaces pycsou_tpu/kernels/tvr.py tv_pds_megar_step (_tv_megar_kernel
// via _megar_call): K4 without mask=, K7 with it ('megarm'; the mask
// multiply is tvr.py:155-156).  The shard variants are not ported.
//
// Bound by device-memory traffic: 7 image streams a step (x, atb, z0, z1
// in; x', z0', z1' out), 8 with K7's m; the Gram's t = A x and the gradient
// stay in shared memory.  Each block owns a 32 x 32 output tile and
// computes the gradient on the tile grown by one row and column (the
// stencil's forward differences read u one pixel down and right), which
// needs x over the forward + adjoint reach + 1 (K7 reads m over the tile
// grown by the adjoint reach + 1, where t lives).  The outputs go to
// buffers separate from the inputs: a block reads its neighbours' x and z,
// so updating in place (as the TPU kernel did on its ordered grid) would
// race.  Masked is a template parameter, so K4's instantiation is the
// unmasked code unchanged.
#include "sepconv.cuh"
#include "pds_stencil.cuh"

namespace pct {

template <bool Masked>
__global__ void __launch_bounds__(kThreads)
tv_megar_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ m,
                const float* __restrict__ atb, float* __restrict__ xo, float* __restrict__ z0o,
                float* __restrict__ z1o, float* __restrict__ partials, int H, int W,
                const float* __restrict__ taps, int rank, int Ku, int Kv, int ouf, int ovf, int oua,
                int ova, float atb_coef, PdsParams p) {
  extern __shared__ float smem[];
  const int ntaps = 2 * rank * (Ku + Kv);
  load_taps(smem, taps, ntaps);
  const GramTaps gt{smem, smem + rank * Ku, smem + rank * (Ku + Kv),
                    smem + rank * (2 * Ku + Kv), rank, Ku, Kv, ouf, ovf, oua, ova};
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  Region G{smem + ntaps, r0, c0, kTile + 1, kTile + 1};
  gram_into<Masked>(x, H, W, gt, G, G.p + G.nr * G.nc, m);

  auto at = [W](const float* a) {
    return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
  };
  const float* gs = G.p;
  const int gnc = G.nc;
  auto grad = [=](int r, int c) {
    return gs[(r - r0) * gnc + (c - c0)] - atb_coef * __ldg(atb + (size_t)r * W + c);
  };
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= H || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, at(x), grad, at(z0), at(z1));
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

}  // namespace pct

using namespace pct;

extern "C" {

// taps = [uf | vf | ua | va] with the gradient's 2x already in ua;
// g = (A^H diag(m) A x) - atb_coef * atb feeds the stencil.  m == nullptr
// launches K4 (no mask), else K7.
int pct_tv_megar(const float* x, const float* z0, const float* z1, const float* m,
                 const float* atb, float* xo, float* z0o, float* z1o, float* partials,
                 float* stats, int H, int W, const float* taps, int rank, int Ku, int Kv, int ouf,
                 int ovf, int oua, int ova, float atb_coef, float tau, float sigma, float rho,
                 float lam, int nonneg, int iso, void* stream) {
  const size_t floats = 2 * rank * (Ku + Kv) + (kTile + 1) * (kTile + 1) +
                        gram_scratch_floats(kTile + 1, kTile + 1, Ku, Kv);
  const size_t bytes = floats * sizeof(float);
  auto kernel = m ? tv_megar_kernel<true> : tv_megar_kernel<false>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, z0, z1, m, atb, xo, z0o, z1o, partials, H, W, taps, rank, Ku, Kv, ouf, ovf, oua, ova,
      atb_coef, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
