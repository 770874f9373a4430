// Separable 'same' convolution passes over shared-memory tiles.
//
// Shared by the convolution sweep (K1, conv2d.cu), the fused Gram (K2,
// conv2d.cu) and the fused TV steps (K4, K7, tvr.cu).  The convention is the
// package's 'same' convolution with zero boundary:
//
//     y[p] = sum_j h[j] x[p + o - j],   o = K // 2 (forward)
//
// and the adjoint is the same pass with flipped taps at o' = K - 1 - o.
// Taps are f32 and every product is an f32 FMA: the TPU kernels' bf16x3
// split-dot machinery has no counterpart here.
#pragma once

#include <cuda_runtime.h>

namespace pct {

constexpr int kMaxTaps = 31;  // per axis: reach <= 15 on either side
constexpr int kMaxRank = 4;
constexpr int kTile = 32;     // output tile edge (rows and columns)
constexpr int kThreads = 256;

// A rectangle [r0, r0 + nr) x [c0, c0 + nc) of global image coordinates,
// held row-major (stride nc) in shared memory.
struct Region {
  float* p;
  int r0, c0, nr, nc;
};

// Region `in` must cover what a pass into `out` reads: rows
// [out.r0 - (K - 1 - o), out.r0 + out.nr - 1 + o], likewise columns.
__device__ __forceinline__ Region source_region(const Region& out, int Ku, int Kv, int ou, int ov,
                                                float* p) {
  return Region{p, out.r0 - (Ku - 1 - ou), out.c0 - (Kv - 1 - ov), out.nr + Ku - 1,
                out.nc + Kv - 1};
}

// Zero-padded copy of a global (H, W) image into a region.
__device__ __forceinline__ void load_region(Region d, const float* __restrict__ src, int H, int W) {
  for (int i = threadIdx.x; i < d.nr * d.nc; i += blockDim.x) {
    const int r = d.r0 + i / d.nc;
    const int c = d.c0 + i % d.nc;
    d.p[i] = (r >= 0 && r < H && c >= 0 && c < W) ? __ldg(src + (size_t)r * W + c) : 0.f;
  }
}

// Shard: a row shard of an (H, W) image, read at global (r, c) by the
// shard kernels K14, K15 and K16.  The core rows [row0, row0 + hloc) are
// `core`; the R rows above are `top` and the R rows below `bot`, each
// (R, W), as the neighbouring shards send them (zeros beyond the image's
// edges).  Rows outside [row0 - R, row0 + hloc + R) are not held: a load
// reads them as 0, and the kernels use such values only on rows they do not
// write (each checks that R covers its reach).
struct Shard {
  const float *top, *core, *bot;
  int row0, hloc, R, W;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int l = r - row0;
    const float* row = l < 0 ? top + (size_t)(l + R) * W
                       : l < hloc ? core + (size_t)l * W
                                  : bot + (size_t)(l - hloc) * W;
    return __ldg(row + c);
  }
};

// A shard kernel takes, for each image a, three __restrict__ pointers:
// a##t the rows above, a the core, a##b the rows below.  It builds all its
// Shards from its one (row0, hloc, R, W), so that the compiler shares their
// index arithmetic.
#define PCT_IMAGE(a) \
  const float* __restrict__ a##t, const float* __restrict__ a, const float* __restrict__ a##b

// Zero-padded copy of a shard's rows into a region: 0 outside the rows it
// holds, [row0 - R, row0 + hloc + R) within [0, H).
__device__ __forceinline__ void load_region(Region d, const Shard& src, int H, int W) {
  const int lo = max(0, src.row0 - src.R), hi = min(H, src.row0 + src.hloc + src.R);
  for (int i = threadIdx.x; i < d.nr * d.nc; i += blockDim.x) {
    const int r = d.r0 + i / d.nc;
    const int c = d.c0 + i % d.nc;
    d.p[i] = (r >= lo && r < hi && c >= 0 && c < W) ? src(r, c) : 0.f;
  }
}

// Shard2D: a block of a 2-D mesh of an (H, W) image, read at global (r, c)
// by K17.  The core rows [row0, row0 + hloc) are `core`, the R rows above
// `top` and the R rows below `bot`; each holds the block's columns
// [col0, col0 + wloc) with C columns of its left and right neighbours on
// either side (the lane extension), so a row has ld = wloc + 2C floats and
// global column c sits at c - col0 + C.  The corner columns of `top` and
// `bot` come from the diagonal neighbours.  What lies outside the held
// window [row0 - R, row0 + hloc + R) x [col0 - C, col0 + wloc + C) a load
// reads as 0, as for Shard.
struct Shard2D {
  const float *top, *core, *bot;
  int row0, hloc, R, col0, wloc, C;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int l = r - row0;
    const size_t ld = (size_t)(wloc + 2 * C);
    const float* row = l < 0 ? top + (size_t)(l + R) * ld
                       : l < hloc ? core + (size_t)l * ld
                                  : bot + (size_t)(l - hloc) * ld;
    return __ldg(row + (c - col0 + C));
  }
};

// Zero-padded copy of a 2-D shard's window into a region: 0 outside the
// window it holds and outside [0, H) x [0, W).
__device__ __forceinline__ void load_region(Region d, const Shard2D& src, int H, int W) {
  const int lo = max(0, src.row0 - src.R), hi = min(H, src.row0 + src.hloc + src.R);
  const int clo = max(0, src.col0 - src.C), chi = min(W, src.col0 + src.wloc + src.C);
  for (int i = threadIdx.x; i < d.nr * d.nc; i += blockDim.x) {
    const int r = d.r0 + i / d.nc;
    const int c = d.c0 + i % d.nc;
    d.p[i] = (r >= lo && r < hi && c >= clo && c < chi) ? src(r, c) : 0.f;
  }
}

// Copy `n` floats from global to shared memory.
__device__ __forceinline__ void load_taps(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// out = sum_k C(v_k) R(u_k) in, evaluated on the region `out`.
//   R(u): y(r, c) = sum_j u[j] in(r + ou - j, c)   (along rows)
//   C(v): y(r, c) = sum_j v[j] in(r, c + ov - j)   (along columns)
// u is (rank, Ku) and v (rank, Kv), row-major.  `tmp` holds out.nr * in.nc
// floats.  Ends with a block barrier, so `out` is ready for every thread.
__device__ inline void sep_same_pass(Region in, Region out, float* tmp, const float* u, const float* v,
                              int rank, int Ku, int Kv, int ou, int ov) {
  for (int k = 0; k < rank; ++k) {
    const float* uk = u + k * Ku;
    const float* vk = v + k * Kv;
    const int row0 = out.r0 + ou - in.r0;  // in-row read by tap 0 for out-row 0
    for (int i = threadIdx.x; i < out.nr * in.nc; i += blockDim.x) {
      const int rr = i / in.nc;
      const int c = i - rr * in.nc;
      const float* src = in.p + (row0 + rr) * in.nc + c;
      float acc = 0.f;
      for (int j = 0; j < Ku; ++j) acc = fmaf(uk[j], src[-j * in.nc], acc);
      tmp[i] = acc;
    }
    __syncthreads();
    const int col0 = out.c0 + ov - in.c0;
    for (int i = threadIdx.x; i < out.nr * out.nc; i += blockDim.x) {
      const int rr = i / out.nc;
      const int c = i - rr * out.nc;
      const float* src = tmp + rr * in.nc + col0 + c;
      float acc = 0.f;
      for (int j = 0; j < Kv; ++j) acc = fmaf(vk[j], src[-j], acc);
      out.p[i] = (k == 0) ? acc : out.p[i] + acc;
    }
    __syncthreads();
  }
}

// Taps of a forward and an adjoint factor stack, as the wrappers pack them:
// [uf (rank, Ku) | vf (rank, Kv) | ua (rank, Ku) | va (rank, Kv)].
struct GramTaps {
  const float *uf, *vf, *ua, *va;
  int rank, Ku, Kv, ouf, ovf, oua, ova;
};

// Shared-memory floats gram_into needs for an output region of nr x nc.
__host__ __device__ __forceinline__ int gram_scratch_floats(int nr, int nc, int Ku, int Kv) {
  const int tr = nr + Ku - 1, tc = nc + Kv - 1;  // t = A x
  const int xr = tr + Ku - 1, xc = tc + Kv - 1;  // x
  const int tmp_a = tr * xc, tmp_b = nr * tc;
  return tr * tc + xr * xc + (tmp_a > tmp_b ? tmp_a : tmp_b);
}

// G.p = (A^H A x) on region G: the forward pass t = A x on G grown by the
// adjoint reach, t zeroed outside the image (the 'same' crop: t = A x
// exists only on [0, H) x [0, W)), then the adjoint pass.  t never leaves
// shared memory.  With Masked, t is multiplied by the (H, W) data mask m
// after the crop, for the Gram A^H diag(m) A.  x is an (H, W) image in
// device memory or a Shard.
template <bool Masked = false, class Src>
__device__ inline void gram_into(Src x, int H, int W, const GramTaps& g, Region G,
                          float* scratch, const float* __restrict__ m = nullptr) {
  Region T = source_region(G, g.Ku, g.Kv, g.oua, g.ova, scratch);
  Region X = source_region(T, g.Ku, g.Kv, g.ouf, g.ovf, T.p + T.nr * T.nc);
  float* tmp = X.p + X.nr * X.nc;
  load_region(X, x, H, W);
  __syncthreads();
  sep_same_pass(X, T, tmp, g.uf, g.vf, g.rank, g.Ku, g.Kv, g.ouf, g.ovf);
  for (int i = threadIdx.x; i < T.nr * T.nc; i += blockDim.x) {
    const int r = T.r0 + i / T.nc;
    const int c = T.c0 + i % T.nc;
    if (r < 0 || r >= H || c < 0 || c >= W)
      T.p[i] = 0.f;
    else if (Masked)
      T.p[i] *= __ldg(m + (size_t)r * W + c);
  }
  __syncthreads();
  sep_same_pass(T, G, tmp, g.ua, g.va, g.rank, g.Ku, g.Kv, g.oua, g.ova);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <class Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace pct
