// K6: two masked TV primal-dual iterations in one kernel (the data
// gradient of a diagonal Gram, g = 2 (m x - atb), formed in the kernel),
// with the stopping-metric partial sums of the second iteration only.
//
// Replaces pycsou_tpu/kernels/tv.py tv_pds_sweepm2_step
// (_tv_sweepm2_kernel).  The TPU kernel runs a two-stage software pipeline
// over an ordered grid of row tiles: stage 1 of tile i-1 and stage 2 of
// tile i-2 in one grid step, the stage-1 rows in a scratch ring.  Blocks on
// the card run in no order, so here each block does temporal blocking in
// shared memory instead: it owns a 32 x 32 output tile, loads x, m, atb,
// z0 and z1 over the tile grown by 2 on every side (one iteration at
// (r, c) reads (r +- 1, c +- 1), the diagonals (r + 1, c - 1) and
// (r - 1, c + 1) included), computes iteration 1 over the tile grown by 1
// into shared memory, and iteration 2 over the tile from those values.
// The first iteration's values never reach device memory.
//
// Bound by device-memory traffic: 8 image streams for TWO iterations (x, m,
// atb, z0, z1 in, re-read by 1.27x for the 2-pixel halo; x'', z0'', z1''
// out), half of K5's bytes per iteration, at the price of computing the
// first iteration on the 34 x 34 grown tile (13% more stencil work).
// Image borders: pds_stencil reads only in-image neighbours and masks the
// dual invariant (last row of z0, last column of z1 read as 0), so
// stage-1 values outside the image are never read; they are written as 0.
#include "sepconv.cuh"
#include "pds_stencil.cuh"

namespace pct {

constexpr int kIn = kTile + 4;   // inputs: the tile grown by 2
constexpr int kMid = kTile + 2;  // iteration 1: the tile grown by 1

__global__ void __launch_bounds__(kThreads)
tv_sweepm2_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                  const float* __restrict__ z1, const float* __restrict__ m,
                  const float* __restrict__ atb, float* __restrict__ xo, float* __restrict__ z0o,
                  float* __restrict__ z1o, float* __restrict__ partials, int H, int W,
                  PdsParams p) {
  __shared__ float sx[kIn * kIn], sm[kIn * kIn], sa[kIn * kIn], sz0[kIn * kIn], sz1[kIn * kIn];
  __shared__ float tx[kMid * kMid], tz0[kMid * kMid], tz1[kMid * kMid];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int ri = r0 - 2, ci = c0 - 2;  // origin of the input region
  const int rm = r0 - 1, cm = c0 - 1;  // origin of iteration 1's region

  for (int i = threadIdx.x; i < kIn * kIn; i += blockDim.x) {
    const int r = ri + i / kIn, c = ci + i % kIn;
    const bool in = r >= 0 && r < H && c >= 0 && c < W;
    const size_t k = (size_t)r * W + c;
    sx[i] = in ? __ldg(x + k) : 0.f;
    sm[i] = in ? __ldg(m + k) : 0.f;
    sa[i] = in ? __ldg(atb + k) : 0.f;
    sz0[i] = in ? __ldg(z0 + k) : 0.f;
    sz1[i] = in ? __ldg(z1 + k) : 0.f;
  }
  __syncthreads();

  // accessors in global image coordinates (lambdas capture pointers: a
  // shared array captured by value would be copied)
  const float* const pm = sm;
  const float* const pa = sa;
  const float* const px = sx;
  const float* const ptx = tx;
  auto in_at = [=](const float* s) {
    return [=](int r, int c) { return s[(r - ri) * kIn + (c - ci)]; };
  };
  auto mid_at = [=](const float* s) {
    return [=](int r, int c) { return s[(r - rm) * kMid + (c - cm)]; };
  };

  // iteration 1 over the tile grown by 1
  auto grad0 = [=](int r, int c) {
    const int k = (r - ri) * kIn + (c - ci);
    return masked_grad(pm[k], px[k], pa[k]);
  };
  for (int i = threadIdx.x; i < kMid * kMid; i += blockDim.x) {
    const int r = rm + i / kMid, c = cm + i % kMid;
    if (r < 0 || r >= H || c < 0 || c >= W) {
      tx[i] = tz0[i] = tz1[i] = 0.f;
      continue;
    }
    const PdsOut o = pds_stencil(r, c, H, W, p, in_at(sx), grad0, in_at(sz0), in_at(sz1));
    tx[i] = o.xn;
    tz0[i] = o.z0n;
    tz1[i] = o.z1n;
  }
  __syncthreads();

  // iteration 2 over the tile, from iteration 1's values
  auto grad1 = [=](int r, int c) {
    const int k = (r - ri) * kIn + (c - ci);
    return masked_grad(pm[k], ptx[(r - rm) * kMid + (c - cm)], pa[k]);
  };
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= H || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, mid_at(tx), grad1, mid_at(tz0), mid_at(tz1));
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);  // the second iteration against the first
  }
  block_stats(st, partials);
}

}  // namespace pct

using namespace pct;

extern "C" {

// Same conventions as pct_tv_sweepm_stats (tv.cu); the outputs are the
// state after two iterations, stats those of the second.
int pct_tv_sweepm2(const float* x, const float* z0, const float* z1, const float* m,
                   const float* atb, float* xo, float* z0o, float* z1o, float* partials,
                   float* stats, int H, int W, float tau, float sigma, float rho, float lam,
                   int nonneg, int iso, void* stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  tv_sweepm2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, z0, z1, m, atb, xo, z0o,
                                                                 z1o, partials, H, W, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
