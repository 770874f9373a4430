// The TV primal-dual (Condat-Vu) stencil, shared by K3, K5 and K13 (tv.cu),
// K4 and K7 (tvr.cu), K6 (tvm2.cu), K10-K12 and K14 (tvr1.cu), and the
// stopping-metric partial sums they emit.
//
// One update at pixel p = (r, c), given the data gradient g:
//
//     x_t = P(x - tau g - tau div z)        P = max(., 0) when nonneg
//     u   = 2 x_t - x
//     v   = z + sigma grad u
//     z_t = proj(v)                         L2 ball of radius lam jointly
//                                           over (v0, v1) (isotropic TV) or
//                                           the [-lam, lam] box (anisotropic)
//     x'  = rho x_t + (1 - rho) x,  z' = rho z_t + (1 - rho) z
//
// grad is the forward difference with a zero last row/column and div its
// adjoint, (D^T y)_j = y_{j-1} - y_j.  The last row of z0 and the last
// column of z1 are read as 0 and come out 0 (the dual invariant).
#pragma once

#include <cuda_runtime.h>

namespace pct {

struct PdsParams {
  float tau, sigma, rho, lam;
  int nonneg, iso;
};

// Per-pixel results: the three new values and the three old ones the
// stopping metric compares them with (z read through the invariant masks).
struct PdsOut {
  float xn, z0n, z1n, xo, z0o, z1o;
};

// The dual masked by the invariant: z0 read as 0 on the last row, z1 on the
// last column (and both outside the image).  AtEdge false: the caller
// reads only pixels clear of the image's edges (K6's inner tiles), where
// every mask and every test for the last row or column holds; none is made.
template <class FZ0, class FZ1, bool AtEdge = true>
struct MaskedDual {
  FZ0 Z0;
  FZ1 Z1;
  int H, W;
  __device__ __forceinline__ float z0(int r, int c) const {
    return (!AtEdge || (r >= 0 && r < H - 1 && c >= 0 && c < W)) ? Z0(r, c) : 0.f;
  }
  __device__ __forceinline__ float z1(int r, int c) const {
    return (!AtEdge || (r >= 0 && r < H && c >= 0 && c < W - 1)) ? Z1(r, c) : 0.f;
  }
  // x_t at (r, c) from x there: P(x - tau g - tau div z)
  template <class FG>
  __device__ __forceinline__ float x_t(int r, int c, float xv, FG G, const PdsParams& p) const {
    const float div = (z0(r - 1, c) - z0(r, c)) + (z1(r, c - 1) - z1(r, c));
    const float v = xv - p.tau * G(r, c) - p.tau * div;
    return p.nonneg ? fmaxf(v, 0.f) : v;
  }
};

// X, G, Z0, Z1: callables returning the value at an in-image (r, c).
template <class FX, class FG, class FZ0, class FZ1>
__device__ __forceinline__ PdsOut pds_stencil(int r, int c, int H, int W, const PdsParams& p,
                                              FX X, FG G, FZ0 Z0, FZ1 Z1) {
  const MaskedDual<FZ0, FZ1> z{Z0, Z1, H, W};
  const float x0 = X(r, c);
  const float xt = z.x_t(r, c, x0, G, p);
  const float u = 2.f * xt - x0;
  float du_r = 0.f, du_c = 0.f;
  if (r < H - 1) {
    const float xd = X(r + 1, c);
    du_r = (2.f * z.x_t(r + 1, c, xd, G, p) - xd) - u;
  }
  if (c < W - 1) {
    const float xr = X(r, c + 1);
    du_c = (2.f * z.x_t(r, c + 1, xr, G, p) - xr) - u;
  }
  const float z0 = z.z0(r, c), z1 = z.z1(r, c);
  const float v0 = z0 + p.sigma * du_r;
  const float v1 = z1 + p.sigma * du_c;
  float z0t, z1t;
  if (p.iso) {
    const float scale = p.lam / fmaxf(sqrtf(v0 * v0 + v1 * v1), p.lam);
    z0t = v0 * scale;
    z1t = v1 * scale;
  } else {
    z0t = fminf(fmaxf(v0, -p.lam), p.lam);
    z1t = fminf(fmaxf(v1, -p.lam), p.lam);
  }
  const float keep = 1.f - p.rho;
  return PdsOut{p.rho * xt + keep * x0, p.rho * z0t + keep * z0, p.rho * z1t + keep * z1,
                x0, z0, z1};
}

// pds_stencil's arithmetic from x_t and x at (r, c) (xt, x0), one row down
// (xtd, xd; read only when r < H - 1) and one column right (xtr, xr; read
// only when c < W - 1), for a caller that holds each x_t once (K6,
// K10-K12, K14, K16) instead of computing it for every pixel that reads it.
// pds_stencil keeps its own copy of these lines, so that the other
// kernels' machine code stays as it was.
template <class FZ0, class FZ1, bool AtEdge>
__device__ __forceinline__ PdsOut pds_update(int r, int c, int H, int W, const PdsParams& p,
                                             const MaskedDual<FZ0, FZ1, AtEdge>& z, float x0, float xt, float xd,
                                             float xtd, float xr, float xtr) {
  const float u = 2.f * xt - x0;
  float du_r = 0.f, du_c = 0.f;
  if (!AtEdge || r < H - 1) du_r = (2.f * xtd - xd) - u;
  if (!AtEdge || c < W - 1) du_c = (2.f * xtr - xr) - u;
  const float z0 = z.z0(r, c), z1 = z.z1(r, c);
  const float v0 = z0 + p.sigma * du_r;
  const float v1 = z1 + p.sigma * du_c;
  float z0t, z1t;
  if (p.iso) {
    const float scale = p.lam / fmaxf(sqrtf(v0 * v0 + v1 * v1), p.lam);
    z0t = v0 * scale;
    z1t = v1 * scale;
  } else {
    z0t = fminf(fmaxf(v0, -p.lam), p.lam);
    z1t = fminf(fmaxf(v1, -p.lam), p.lam);
  }
  const float keep = 1.f - p.rho;
  return PdsOut{p.rho * xt + keep * x0, p.rho * z0t + keep * z0, p.rho * z1t + keep * z1,
                x0, z0, z1};
}

// The data gradient of a diagonal Gram m (K5, K6): g = 2 (m x - atb),
// rounded as the plain version rounds it (no fused multiply-add).
__device__ __forceinline__ float masked_grad(float m, float x, float atb) {
  return 2.f * __fsub_rn(__fmul_rn(m, x), atb);
}

// Running per-thread sums: [|dx|^2, |x|^2, |dz0|^2, |z0|^2, |dz1|^2, |z1|^2].
struct Stats6 {
  float s[6];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = 0.f;
  }
  __device__ __forceinline__ void add(const PdsOut& o) {
    const float dx = o.xn - o.xo, d0 = o.z0n - o.z0o, d1 = o.z1n - o.z1o;
    s[0] = fmaf(dx, dx, s[0]);
    s[1] = fmaf(o.xo, o.xo, s[1]);
    s[2] = fmaf(d0, d0, s[2]);
    s[3] = fmaf(o.z0o, o.z0o, s[3]);
    s[4] = fmaf(d1, d1, s[4]);
    s[5] = fmaf(o.z1o, o.z1o, s[5]);
  }
};

// Block sum of the six partials in a fixed order, written to
// partials[block * 6 + k].  Blocks run in no order on the card, so each
// writes its own slot and stats_fold adds the slots up afterwards.
// NT: the block's thread count.
template <int NT = kThreads>
__device__ inline void block_stats(Stats6 st, float* __restrict__ partials) {
  __shared__ float warp_sums[NT / 32][6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = st.s[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += warp_sums[w][threadIdx.x];
    const int block = blockIdx.y * gridDim.x + blockIdx.x;
    partials[block * 6 + threadIdx.x] = v;
  }
}

// Second pass: one block folds the per-block partials in a fixed order
// (f64 accumulation), so the metric is deterministic run to run.
static __global__ void stats_fold(const float* __restrict__ partials, int nblocks,
                                  float* __restrict__ stats) {
  __shared__ double acc[kThreads][6];
  double s[6] = {0, 0, 0, 0, 0, 0};
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    for (int k = 0; k < 6; ++k) s[k] += (double)partials[b * 6 + k];
  for (int k = 0; k < 6; ++k) acc[threadIdx.x][k] = s[k];
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half)
      for (int k = 0; k < 6; ++k) acc[threadIdx.x][k] += acc[threadIdx.x + half][k];
    __syncthreads();
  }
  if (threadIdx.x < 6) stats[threadIdx.x] = (float)acc[0][threadIdx.x];
}

}  // namespace pct
