// K3: one TV primal-dual stencil step from a given data gradient g, with
// the stopping-metric partial sums.  K16: K3 on a row shard of the image.
// K5: the same step with the gradient of a diagonal Gram, g = 2 (m x -
// atb), formed in the kernel.  K13: K3's step on a stacked dual z (2, H,
// W), without the partial sums.
//
// K3 replaces pycsou_tpu/kernels/tv.py tv_pds_sweep_step_stats (and the
// stacked-dual tv_pds_stencil_step_sweep): _tv_sweep_kernel via
// _sweep_call, stencil _pds_stencil, dual prox _dual_prox, stats
// _stats_update.  K16 replaces tv_pds_sweep_shard_step (the same kernel in
// shard mode).  K5 replaces tv_pds_sweepm_step_stats (_tv_sweepm_kernel).
// K13 replaces tv_pds_stencil_step (_tv_kernel, the Element-halo blocks).
//
// Bound by device-memory traffic: 7 image streams a step for K3 and K13 (x,
// g, z0, z1 in; x', z0', z1' out), 8 for K5 (x, m, atb, z0, z1 in); K16
// adds one halo row of x, g, z0 and z1 from each neighbour.  Each thread
// updates one pixel and reads its neighbours' inputs straight from global
// memory; the re-reads hit L1.  The outputs go to buffers separate from the
// inputs: the TPU kernels updated x, z0 and z1 in place, which is safe only
// on a grid that runs in order.  Per-block partial sums are folded by
// stats_fold.
//
// K16 is K3's code over a row source (the Shard of sepconv.cuh) in place of
// the (H, W) pointers; K3 keeps its own kernel, so that its code is that of
// the single-device engine alone.  K16 reads the shard's core rows
// [row0, row0 + hloc) and the neighbours' halo rows, and keys every
// boundary (the dual masks, the zero last row of the forward difference)
// to the global row and the global height H.
#include "sepconv.cuh"
#include "pds_stencil.cuh"

namespace pct {

__global__ void __launch_bounds__(kThreads)
tv_sweep_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ g,
                float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                float* __restrict__ partials, int H, int W, PdsParams p) {
  auto at = [W](const float* a) {
    return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
  };
  Stats6 st;
  st.zero();
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= H || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, at(x), at(g), at(z0), at(z1));
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

__global__ void __launch_bounds__(kThreads)
tv_sweep_shard_kernel(PCT_IMAGE(x), PCT_IMAGE(z0), PCT_IMAGE(z1), PCT_IMAGE(g),
                      float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                      float* __restrict__ partials, int row0, int hloc, int R, int H, int W,
                      PdsParams p) {
  const Shard X{xt, x, xb, row0, hloc, R, W};
  const Shard Z0{z0t, z0, z0b, row0, hloc, R, W};
  const Shard Z1{z1t, z1, z1b, row0, hloc, R, W};
  const Shard G{gt, g, gb, row0, hloc, R, W};
  Stats6 st;
  st.zero();
  const int r0 = row0 + blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= row0 + hloc || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, X, G, Z0, Z1);
    const size_t k = (size_t)(r - row0) * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

__global__ void __launch_bounds__(kThreads)
tv_sweepm_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                 const float* __restrict__ z1, const float* __restrict__ m,
                 const float* __restrict__ atb, float* __restrict__ xo, float* __restrict__ z0o,
                 float* __restrict__ z1o, float* __restrict__ partials, int H, int W,
                 PdsParams p) {
  auto at = [W](const float* a) {
    return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
  };
  auto grad = [=](int r, int c) {
    const size_t k = (size_t)r * W + c;
    return masked_grad(__ldg(m + k), __ldg(x + k), __ldg(atb + k));
  };
  Stats6 st;
  st.zero();
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
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

__global__ void __launch_bounds__(kThreads)
tv_stencil_kernel(const float* __restrict__ x, const float* __restrict__ z,
                  const float* __restrict__ g, float* __restrict__ xo, float* __restrict__ zo,
                  int H, int W, PdsParams p) {
  auto at = [W](const float* a) {
    return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
  };
  const size_t HW = (size_t)H * W;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= H || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, at(x), at(g), at(z), at(z + HW));
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    zo[k] = o.z0n;
    zo[HW + k] = o.z1n;
  }
}

}  // namespace pct

using namespace pct;

extern "C" {

// partials: (grid blocks * 6) scratch; stats: (6,) output.
int pct_tv_sweep_stats(const float* x, const float* z0, const float* z1, const float* g, float* xo,
                       float* z0o, float* z1o, float* partials, float* stats, int H, int W,
                       float tau, float sigma, float rho, float lam, int nonneg, int iso,
                       void* stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  tv_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, z0, z1, g, xo, z0o, z1o,
                                                               partials, H, W, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

// K16: x, z0, z1, g are the shard's core (hloc, W) blocks of global rows
// [row0, row0 + hloc) of an (H, W) image; xt, xb, ..., z1b are the (R, W)
// halo blocks above (t) and below (b) it, R >= 1; the outputs are
// core-shaped, the stats those of the core.
int pct_tv_sweep_shard(const float* x, const float* z0, const float* z1, const float* g,
                       const float* xt, const float* xb, const float* gt, const float* gb,
                       const float* z0t, const float* z0b, const float* z1t, const float* z1b,
                       float* xo, float* z0o, float* z1o, float* partials, float* stats, int row0,
                       int hloc, int R, int H, int W, float tau, float sigma, float rho, float lam,
                       int nonneg, int iso, void* stream) {
  dim3 grid((W + kTile - 1) / kTile, (hloc + kTile - 1) / kTile);
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  tv_sweep_shard_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xt, x, xb, z0t, z0, z0b, z1t, z1, z1b, gt, g, gb, xo, z0o, z1o, partials, row0, hloc, R, H, W,
      p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

// K5; same conventions as pct_tv_sweep_stats, m and atb in place of g.
int pct_tv_sweepm_stats(const float* x, const float* z0, const float* z1, const float* m,
                        const float* atb, float* xo, float* z0o, float* z1o, float* partials,
                        float* stats, int H, int W, float tau, float sigma, float rho, float lam,
                        int nonneg, int iso, void* stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  tv_sweepm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, z0, z1, m, atb, xo, z0o, z1o,
                                                                partials, H, W, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

// K13: z and zo are stacked (2, H, W) duals; no partial sums.
int pct_tv_stencil(const float* x, const float* z, const float* g, float* xo, float* zo, int H,
                   int W, float tau, float sigma, float rho, float lam, int nonneg, int iso,
                   void* stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  tv_stencil_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, z, g, xo, zo, H, W, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
