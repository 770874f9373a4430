// K4: one full TV primal-dual iteration for a rank <= 4 PSF in a single
// kernel: forward convolution, adjoint convolution (2x folded into the
// adjoint row taps), the stencil of K3, and the metric partial sums.
// K7 is the same kernel instantiated with Masked: the data mask m
// multiplies t = A x after the 'same' crop, so the Gram is A^H diag(m) A
// (blurred, partially sampled data).
//
// Replaces pycsou_tpu/kernels/tvr.py tv_pds_megar_step (_tv_megar_kernel
// via _megar_call): K4 without mask=, K7 with it ('megarm'; the mask
// multiply is tvr.py:155-156).  K15 is K4 on a row shard of the image and
// replaces tv_pds_megar_shard_step (the same kernel in shard mode); K17 is
// K4 on a block of a 2-D (sp0, sp1) mesh and replaces
// tv_pds_megar_shard2d_step (the same kernel with CORE_L = 128 lanes).
//
// What bounds it.  Each block owns a 32 x 32 output tile and computes the
// gradient on the tile grown by one row and column (the stencil's forward
// differences read u one pixel down and right), which needs x over the
// forward + adjoint reach + 1.  Device memory sees 7 image streams a step (x,
// atb, z0, z1 in; x', z0', z1' out), 8 with K7's m: 0.14 ms at 4096^2 at an
// H100 SXM's 3.35 TB/s (its 700 W limit).  The Gram (sepconv.cuh gram_into:
// four passes of K taps a rank term over the 33 x 33 gradient region grown by
// the reach, about 116k FMAs a tile and term for K = 15, 1.9 G at 4096^2)
// needs 0.06 ms a rank term at the same card's float32 rate, so long as its
// passes are not bound by shared-memory loads: they are register-blocked,
// with the taps in this kernel's parameters (GramTaps, padded to K = 7, 15 or
// 31, the template parameter).  t = A x and the gradient stay in shared
// memory.  The outputs go to buffers separate from the inputs: a block reads
// its neighbours' x and z, so updating in place (as the TPU kernel did on its
// ordered grid) would race.  Masked is a template parameter, so K4's
// instantiation is the unmasked code alone.
//
// K15 is K4's code over a row source (the Shard of sepconv.cuh) in place of
// the (H, W) pointers; K4 keeps its own kernel, so that its code is that of
// the single-device engine alone.  K15 reads the shard's core rows
// [row0, row0 + hloc) with R >= Ku halo rows from each neighbour (x, z0,
// z1) and the halo-extended atb.  Every boundary (the 'same' crop of
// t = A x, the dual masks, the zero last row of the forward difference)
// keys to global rows and the global height H; each block recomputes the
// Gram on its tile's rows from the halos.  The Gram's window finds each
// row's pointer once (load_region); the stencil's reads pick top, core or
// bottom on every read.
//
// K17 is K15 read through Shard2D (sepconv.cuh): the block's core columns
// [col0, col0 + wloc) with C >= Kv columns of its left and right neighbours
// in every row it reads, its top and bottom halos holding the diagonal
// neighbours' corners.  Its grid walks the core's tiles and writes
// core-shaped (hloc, wloc) outputs.  Three widths stay apart: the global W
// (every boundary: the 'same' crop in gram_into, the dual masks and the
// zero last column of the forward difference in pds_stencil, which take
// global (r, c) and (H, W)), the stride wloc + 2C of the extended rows
// (Shard2D alone), and the core's column range (this kernel's tiles and
// output index).
#include "sepconv.cuh"
#include "pds_stencil.cuh"

namespace pct {

constexpr int kGrad = kTile + 1;  // the gradient region: the tile grown by 1 down and right

template <int K, bool Masked>
__global__ void __launch_bounds__(kThreads, Masked ? 1 : gram_min_blocks(K))
tv_megar_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ m,
                const float* __restrict__ atb, float* __restrict__ xo, float* __restrict__ z0o,
                float* __restrict__ z1o, float* __restrict__ partials, int H, int W, GramTaps<K> gt,
                float atb_coef, PdsParams p) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const Region G{smem, r0, c0, kGrad, kGrad, kGrad};
  gram_into<K, Masked>(x, H, W, gt, G, G.p + G.nr * G.s, m);

  auto at = [W](const float* a) {
    return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
  };
  const float* gs = G.p;
  auto grad = [=](int r, int c) {
    return gs[(r - r0) * kGrad + (c - c0)] - atb_coef * __ldg(atb + (size_t)r * W + c);
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

template <int K>
__global__ void __launch_bounds__(kThreads, gram_min_blocks(K))
tv_megar_shard_kernel(PCT_IMAGE(x), PCT_IMAGE(z0), PCT_IMAGE(z1), PCT_IMAGE(atb),
                      float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                      float* __restrict__ partials, int row0, int hloc, int R, int H, int W,
                      GramTaps<K> gt, float atb_coef, PdsParams p) {
  const Shard X{xt, x, xb, row0, hloc, R, W};
  const Shard Z0{z0t, z0, z0b, row0, hloc, R, W};
  const Shard Z1{z1t, z1, z1b, row0, hloc, R, W};
  const Shard A{atbt, atb, atbb, row0, hloc, R, W};
  extern __shared__ float smem[];
  const int r0 = row0 + blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const Region G{smem, r0, c0, kGrad, kGrad, kGrad};
  gram_into<K>(X, H, W, gt, G, G.p + G.nr * G.s);

  const float* gs = G.p;
  auto grad = [=](int r, int c) { return gs[(r - r0) * kGrad + (c - c0)] - atb_coef * A(r, c); };
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= row0 + hloc || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, X, grad, Z0, Z1);
    const size_t k = (size_t)(r - row0) * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

template <int K>
__global__ void __launch_bounds__(kThreads, gram_min_blocks(K))
tv_megar_shard2d_kernel(PCT_IMAGE(x), PCT_IMAGE(z0), PCT_IMAGE(z1), PCT_IMAGE(atb),
                        float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                        float* __restrict__ partials, int row0, int hloc, int R, int col0, int wloc,
                        int C, int H, int W, GramTaps<K> gt, float atb_coef, PdsParams p) {
  const Shard2D X{xt, x, xb, row0, hloc, R, col0, wloc, C};
  const Shard2D Z0{z0t, z0, z0b, row0, hloc, R, col0, wloc, C};
  const Shard2D Z1{z1t, z1, z1b, row0, hloc, R, col0, wloc, C};
  const Shard2D A{atbt, atb, atbb, row0, hloc, R, col0, wloc, C};
  extern __shared__ float smem[];
  const int r0 = row0 + blockIdx.y * kTile, c0 = col0 + blockIdx.x * kTile;
  const Region G{smem, r0, c0, kGrad, kGrad, kGrad};
  gram_into<K>(X, H, W, gt, G, G.p + G.nr * G.s);

  const float* gs = G.p;
  auto grad = [=](int r, int c) { return gs[(r - r0) * kGrad + (c - c0)] - atb_coef * A(r, c); };
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r >= row0 + hloc || c >= col0 + wloc) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, X, grad, Z0, Z1);
    const size_t k = (size_t)(r - row0) * wloc + (c - col0);
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

}  // namespace pct

using namespace pct;

namespace {

// Shared-memory bytes of a megar block: the gradient region and the Gram's
// scratch.
size_t megar_smem_bytes(int K, int rank) {
  return (kGrad * kGrad + gram_scratch_floats(kGrad, kGrad, K, rank)) * sizeof(float);
}

template <int K>
int launch_megar(const float* x, const float* z0, const float* z1, const float* m, const float* atb,
                 float* xo, float* z0o, float* z1o, float* partials, float* stats, int H, int W,
                 const GramTaps<K>& gt, float atb_coef, const PdsParams& p, cudaStream_t s) {
  const size_t bytes = megar_smem_bytes(K, gt.f.rank);
  auto kernel = m ? tv_megar_kernel<K, true> : tv_megar_kernel<K, false>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  kernel<<<grid, kThreads, bytes, s>>>(x, z0, z1, m, atb, xo, z0o, z1o, partials, H, W, gt, atb_coef, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

// x, z0, z1, atb: {top, core, bottom} pointers of each image.
template <int K>
int launch_megar_shard(const float* const x[3], const float* const z0[3], const float* const z1[3],
                       const float* const atb[3], float* xo, float* z0o, float* z1o,
                       float* partials, float* stats, int row0, int hloc, int R, int H, int W,
                       const GramTaps<K>& gt, float atb_coef, const PdsParams& p, cudaStream_t s) {
  const size_t bytes = megar_smem_bytes(K, gt.f.rank);
  cudaError_t err = allow_smem(tv_megar_shard_kernel<K>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (hloc + kTile - 1) / kTile);
  tv_megar_shard_kernel<K><<<grid, kThreads, bytes, s>>>(
      x[0], x[1], x[2], z0[0], z0[1], z0[2], z1[0], z1[1], z1[2], atb[0], atb[1], atb[2], xo, z0o,
      z1o, partials, row0, hloc, R, H, W, gt, atb_coef, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

template <int K>
int launch_megar_shard2d(const float* const x[3], const float* const z0[3], const float* const z1[3],
                         const float* const atb[3], float* xo, float* z0o, float* z1o,
                         float* partials, float* stats, int row0, int hloc, int R, int col0,
                         int wloc, int C, int H, int W, const GramTaps<K>& gt, float atb_coef,
                         const PdsParams& p, cudaStream_t s) {
  const size_t bytes = megar_smem_bytes(K, gt.f.rank);
  cudaError_t err = allow_smem(tv_megar_shard2d_kernel<K>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wloc + kTile - 1) / kTile, (hloc + kTile - 1) / kTile);
  tv_megar_shard2d_kernel<K><<<grid, kThreads, bytes, s>>>(
      x[0], x[1], x[2], z0[0], z0[1], z0[2], z1[0], z1[1], z1[2], atb[0], atb[1], atb[2], xo, z0o,
      z1o, partials, row0, hloc, R, col0, wloc, C, H, W, gt, atb_coef, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// taps = [uf | vf | ua | va] in host memory, with the gradient's 2x already
// in ua; g = (A^H diag(m) A x) - atb_coef * atb feeds the stencil.
// m == nullptr launches K4 (no mask), else K7.
int pct_tv_megar(const float* x, const float* z0, const float* z1, const float* m,
                 const float* atb, float* xo, float* z0o, float* z1o, float* partials,
                 float* stats, int H, int W, const float* taps, int rank, int Ku, int Kv, int ouf,
                 int ovf, int oua, int ova, float atb_coef, float tau, float sigma, float rho,
                 float lam, int nonneg, int iso, void* stream) {
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(K)                                                                            \
  launch_megar<K>(x, z0, z1, m, atb, xo, z0o, z1o, partials, stats, H, W,              \
                  gram_taps<K>(taps, rank, Ku, Kv, ouf, ovf, oua, ova), atb_coef, p, s)
  PCT_DISPATCH_TAPS(Ku, Kv, CALL)
#undef CALL
}

// K15: x, z0, z1 are the shard's core (hloc, W) blocks of global rows
// [row0, row0 + hloc) of an (H, W) image, xt, xb, ..., z1b their (R, W)
// halo blocks above (t) and below (b), R >= Ku, and atb_ext the
// (hloc + 2R, W) halo-extended atb; the rest as pct_tv_megar without m.
int pct_tv_megar_shard(const float* x, const float* z0, const float* z1, const float* atb_ext,
                       const float* xt, const float* xb, const float* z0t, const float* z0b,
                       const float* z1t, const float* z1b, float* xo, float* z0o, float* z1o,
                       float* partials, float* stats, int row0, int hloc, int R, int H, int W,
                       const float* taps, int rank, int Ku, int Kv, int ouf, int ovf, int oua,
                       int ova, float atb_coef, float tau, float sigma, float rho, float lam,
                       int nonneg, int iso, void* stream) {
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t RW = (size_t)R * W;
  const float* X[3] = {xt, x, xb};
  const float* Z0[3] = {z0t, z0, z0b};
  const float* Z1[3] = {z1t, z1, z1b};
  const float* A[3] = {atb_ext, atb_ext + RW, atb_ext + RW + (size_t)hloc * W};
#define CALL(K)                                                                                \
  launch_megar_shard<K>(X, Z0, Z1, A, xo, z0o, z1o, partials, stats, row0, hloc, R, H, W,  \
                        gram_taps<K>(taps, rank, Ku, Kv, ouf, ovf, oua, ova), atb_coef, p, s)
  PCT_DISPATCH_TAPS(Ku, Kv, CALL)
#undef CALL
}

// K17: x, z0, z1 are the block's lane-extended (hloc, wloc + 2C) rows of
// global rows [row0, row0 + hloc) and columns [col0 - C, col0 + wloc + C)
// of an (H, W) image, xt, xb, ..., z1b their (R, wloc + 2C) halo rows above
// (t) and below (b), R >= Ku and C >= Kv, and atb_ext the (hloc + 2R,
// wloc + 2C) fully extended atb; the outputs are the (hloc, wloc) core; the
// rest as pct_tv_megar_shard.
int pct_tv_megar_shard2d(const float* x, const float* z0, const float* z1, const float* atb_ext,
                         const float* xt, const float* xb, const float* z0t, const float* z0b,
                         const float* z1t, const float* z1b, float* xo, float* z0o, float* z1o,
                         float* partials, float* stats, int row0, int hloc, int R, int col0, int wloc,
                         int C, int H, int W, const float* taps, int rank, int Ku, int Kv, int ouf,
                         int ovf, int oua, int ova, float atb_coef, float tau, float sigma, float rho,
                         float lam, int nonneg, int iso, void* stream) {
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t RL = (size_t)R * (wloc + 2 * C);
  const float* X[3] = {xt, x, xb};
  const float* Z0[3] = {z0t, z0, z0b};
  const float* Z1[3] = {z1t, z1, z1b};
  const float* A[3] = {atb_ext, atb_ext + RL, atb_ext + RL + (size_t)hloc * (wloc + 2 * C)};
#define CALL(K)                                                                                 \
  launch_megar_shard2d<K>(X, Z0, Z1, A, xo, z0o, z1o, partials, stats, row0, hloc, R, col0, \
                          wloc, C, H, W, gram_taps<K>(taps, rank, Ku, Kv, ouf, ovf, oua, ova), \
                          atb_coef, p, s)
  PCT_DISPATCH_TAPS(Ku, Kv, CALL)
#undef CALL
}

}  // extern "C"
