// The rank-1 TV engines: one or two full TV primal-dual iterations with the
// exact separable Gram of a rank-1 PSF in its autocorrelation form.
//
//   K11 tv_mega2_kernel  replaces pycsou_tpu/kernels/tv.py tv_pds_mega2_step
//                        (_tv_mega2_kernel, _mega_row_gram, _lane_gram_tile):
//                        one iteration, both Gram directions in the kernel,
//                        with the stopping-metric partial sums.
//   K10 tv_mega3_kernel  replaces tv_pds_mega3_step (_tv_mega3_kernel): two
//                        iterations, the partial sums of the second only.
//   K12 tv_mega_kernel   replaces tv_pds_mega_step (_tv_mega_kernel): the row
//                        Gram of a given w = ColGram(x), then the stencil of
//                        a stacked dual (2, H, W); no partial sums.
//   K14 tv_mega2_shard_kernel  replaces tv_pds_mega2_shard_step (the same
//                        kernel in shard mode): K11 on a row shard's core
//                        rows, with halo rows from its neighbours.
//
// For A = R(u) C(v) the Gram is A^H A = RowGram o ColGram, each the exact
// 1-D 'same'-convolution Gram T^H T: the (2K - 1)-tap autocorrelation band
// (zero boundary) plus dense corrections E_top, E_bot (K - 1 rows of
// L = 2K - 2 taps) on the first and last K - 1 samples of the IMAGE
// (kernels/band.py make_gram_band).  That is two band passes of 2K - 1 taps
// where K4 (tvr.cu) runs four of K taps.  The gradient's 2x is folded into
// the row taps and the row corrections, so g = G x - 2 atb.
//
// Tiles.  Each block owns a 32 x 32 output tile and computes the gradient on
// the tile grown by one row and column (the stencil reads x_t one pixel down
// and right).  The last tile of an axis is shifted back to end on the
// image's edge, so that its windows always hold the rows and columns the
// edge corrections read; such a block writes (and sums) only the pixels of
// its own tile.  The band passes are register-blocked: a thread slides a
// window of NW + 2R values along a row (or column) of shared memory and
// computes NW outputs, with the taps in the kernel's parameter space (R, the
// padded reach, is a template parameter: 0, 4, 8 or 15; taps beyond the
// PSF's reach are 0).  Shared-memory row strides are odd, so a warp's
// column walks are free of bank conflicts.
//
// K10's temporal blocking (as K6 in tvm2.cu): stage 1 computes iteration 1
// over the tile grown by a = max(R, 1) (plus the row and column its
// gradient needs), from x read over the tile grown by 2R + a + 1 (94 x 94
// for a 15-tap PSF); stage 2 computes iteration 2 on the tile from stage
// 1's values, which never leave shared memory.  Stage 2 reads stage 1's x
// over the tile grown by R (its Gram) but its duals only over the tile
// grown by 1, so stage 1 updates the duals there alone and elsewhere only
// x (the primal half of the stencil, the same arithmetic); this keeps the
// block at 102 KB of shared memory, two blocks an SM.  Stage-1 values
// outside the image are written as 0: the zero boundary of the second
// Gram.
//
// K14 is K11's code over a row source (the Shard of sepconv.cuh) in place
// of the (H, W) pointers; K11 keeps its own kernel, so that its code is
// that of the single-device engine alone.  K14's tiles cover the shard's
// core rows [row0, row0 + hloc) of the (H, W) image, the last shifted back
// to end on the core's last row (on the image's edge for the last shard, as
// the edge corrections need).  The x window comes from the core and the
// neighbours' R >= reach + 1 halo rows, 0 beyond them (values that only
// reach rows the block does not write); every boundary keys to global rows
// and the global H.
//
// Bound by device-memory traffic: 7 image streams for K11 (x, atb, z0, z1
// in; x', z0', z1' out), the same 7 for K10's TWO iterations, 8 for K12
// (w, x, atb, z (2) in; x', z' (2) out).  Halo re-reads come from L2.  The
// outputs go to buffers apart from the inputs (blocks read their
// neighbours' values; the TPU kernels updated in place on an ordered grid).
#include <cstring>

#include "sepconv.cuh"
#include "pds_stencil.cuh"

namespace pct {

constexpr int kG = kTile + 1;     // gradient region: the tile grown by 1 down and right
constexpr int kMaxReach = 15;     // padded reach R <= 15 (taps per axis <= 16)
constexpr int kMega3Threads = 512;

// Autocorrelation taps centred at R: ar[R + d] = 2 acorr_rows[K_r - 1 + d]
// (the gradient's 2x folded in), ac[R + d] = acorr_cols[K_c - 1 + d].
struct R1Taps {
  float ar[2 * kMaxReach + 1];
  float ac[2 * kMaxReach + 1];
};

// The edge corrections in device memory: [Etr | Ebr] ((K_r - 1) x L_r each,
// 2x folded in) then [Etc | Ebc] ((K_c - 1) x L_c each).
struct R1Edges {
  const float* E;
  int Kr, Kc;
};

// Origin of block b's tile along an axis of n pixels: the last tile is
// shifted back to end on the edge when the axis holds a whole tile.
__device__ __forceinline__ int tile_origin(int b, int n) {
  const int o = b * kTile;
  return (n >= kTile && o > n - kTile) ? n - kTile : o;
}

// Band pass along a row: out(i, j) = sum_t a[t] in(i, j + t), t in [0, 2R],
// for i < nrows, j < ncols.  A thread computes NW consecutive j of one row
// from a register window; consecutive threads take consecutive rows (odd
// strides: no bank conflicts).  Reads up to in(i, nseg * NW + 2R - 1).
// ROWS selects the row taps (ar) or the column taps (ac).
template <int R, int NW, bool ROWS>
__device__ __forceinline__ void band_along_row(const float* in, int si, float* out, int so,
                                               int nrows, int ncols, const R1Taps& tp) {
  const int nseg = (ncols + NW - 1) / NW;
  for (int it = threadIdx.x; it < nrows * nseg; it += blockDim.x) {
    const int i = it % nrows, j0 = (it / nrows) * NW;
    const float* src = in + i * si + j0;
    float win[NW + 2 * R];
#pragma unroll
    for (int k = 0; k < NW + 2 * R; ++k) win[k] = src[k];
#pragma unroll
    for (int o = 0; o < NW; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t <= 2 * R; ++t) acc = fmaf(ROWS ? tp.ar[t] : tp.ac[t], win[o + t], acc);
      if (j0 + o < ncols) out[i * so + j0 + o] = acc;
    }
  }
}

// Band pass along a column: out(i, j) = sum_t a[t] in(i + t, j); a thread
// computes NW consecutive i of one column; consecutive threads take
// consecutive columns.  Reads up to in(nseg * NW + 2R - 1, j).
template <int R, int NW, bool ROWS>
__device__ __forceinline__ void band_along_col(const float* in, int si, float* out, int so,
                                               int nrows, int ncols, const R1Taps& tp) {
  const int nseg = (nrows + NW - 1) / NW;
  for (int it = threadIdx.x; it < ncols * nseg; it += blockDim.x) {
    const int j = it % ncols, i0 = (it / ncols) * NW;
    const float* src = in + i0 * si + j;
    float win[NW + 2 * R];
#pragma unroll
    for (int k = 0; k < NW + 2 * R; ++k) win[k] = src[k * si];
#pragma unroll
    for (int o = 0; o < NW; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t <= 2 * R; ++t) acc = fmaf(ROWS ? tp.ar[t] : tp.ac[t], win[o + t], acc);
      if (i0 + o < nrows) out[(i0 + o) * so + j] = acc;
    }
  }
}

// The edge corrections of one axis of n samples, added onto a band pass's
// output.  Along that axis, out position a (a < na) is the sample oa0 + a
// and in position ia is the sample ia0 + ia; b (b < nb) runs along the other
// axis.  Output sample g in [0, K - 1) gets sum_l Et[g][l] in(l), sample g in
// [n - K + 1, n) gets sum_l Eb[g - n + K - 1][l] in(n - L + l).  The caller
// guarantees that `in` holds those samples (see the tile comment above).
__device__ __forceinline__ void edge_fix(float* out, int osa, int osb, int oa0, int na, int nb,
                                         const float* in, int isa, int isb, int ia0,
                                         const float* __restrict__ Et, const float* __restrict__ Eb,
                                         int K, int n) {
  if (K <= 1) return;
  const int k1 = K - 1, L = 2 * K - 2;
  const int t0 = max(0, -oa0), t1 = min(na, k1 - oa0);
  const int b0 = max(0, n - k1 - oa0), b1 = min(na, n - oa0);
  const int nt = max(0, t1 - t0), nbot = max(0, b1 - b0);
  for (int it = threadIdx.x; it < (nt + nbot) * nb; it += blockDim.x) {
    const int e = it / nb, b = it - (it / nb) * nb;
    const bool top = e < nt;
    const int a = top ? t0 + e : b0 + e - nt;
    const int g = oa0 + a;
    const float* row = top ? Et + g * L : Eb + (g - (n - k1)) * L;
    const float* src = in + ((top ? 0 : n - L) - ia0) * isa + b * isb;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(__ldg(row + l), src[l * isa], acc);
    out[a * osa + b * osb] += acc;
  }
}

// True when a region [o, o + len) of an axis of n samples meets the first or
// last K - 1 samples (where the edge corrections act).
__device__ __forceinline__ bool meets_edges(int o, int len, int K, int n) {
  return K > 1 && (o < K - 1 || o + len > n - (K - 1));
}

// Zero-padded copy of the (H, W) image rows [r0, r0 + nr) x [c0, c0 + nc)
// into shared memory with row stride s.
__device__ __forceinline__ void load_window(float* d, int s, const float* __restrict__ src, int H,
                                            int W, int r0, int c0, int nr, int nc) {
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
    const int rr = i / nc, cc = i - (i / nc) * nc;
    const int r = r0 + rr, c = c0 + cc;
    d[rr * s + cc] = (r >= 0 && r < H && c >= 0 && c < W) ? __ldg(src + (size_t)r * W + c) : 0.f;
  }
}

// The same from a row shard; rows it does not hold, outside
// [row0 - R, row0 + hloc + R), read as 0.
__device__ __forceinline__ void load_window(float* d, int s, const Shard& src, int H, int W, int r0,
                                            int c0, int nr, int nc) {
  const int lo = max(0, src.row0 - src.R), hi = min(H, src.row0 + src.hloc + src.R);
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
    const int rr = i / nc, cc = i - (i / nc) * nc;
    const int r = r0 + rr, c = c0 + cc;
    d[rr * s + cc] = (r >= lo && r < hi && c >= 0 && c < W) ? src(r, c) : 0.f;
  }
}

// G = Gram(x) - (nothing): the exact rank-1 Gram (2x folded into the rows)
// on the region of nG x nG pixels at (gr, gc), from X, a window of x over
// rows [gr - R, gr + nG + R) and columns [gc - R, gc + nG + R) with stride
// sx.  Wt: (nG + 2R) x nG scratch for ColGram(x), stride sw; G stride sg.
template <int R, int NWc, int NWr>
__device__ __forceinline__ void gram_region(const float* X, int sx, float* Wt, int sw, float* G,
                                            int sg, int gr, int gc, int nG, int H, int W,
                                            const R1Taps& tp, const R1Edges& e) {
  const int nw = nG + 2 * R;
  band_along_row<R, NWc, false>(X, sx, Wt, sw, nw, nG, tp);
  if (meets_edges(gc, nG, e.Kc, W)) {
    __syncthreads();
    const int Lc = 2 * e.Kc - 2, Lr = 2 * e.Kr - 2;
    const float* Etc = e.E + 2 * (e.Kr - 1) * Lr;
    // columns: a = column (stride 1), b = row; X's column 0 is gc - R
    edge_fix(Wt, 1, sw, gc, nG, nw, X + R, 1, sx, gc, Etc, Etc + (e.Kc - 1) * Lc, e.Kc, W);
  }
  __syncthreads();
  band_along_col<R, NWr, true>(Wt, sw, G, sg, nG, nG, tp);
  if (meets_edges(gr, nG, e.Kr, H)) {
    __syncthreads();
    const int Lr = 2 * e.Kr - 2;
    // rows: a = row (stride sg / sw), b = column; Wt's row 0 is gr - R
    edge_fix(G, sg, 1, gr, nG, nG, Wt, sw, 1, gr - R, e.E, e.E + (e.Kr - 1) * Lr, e.Kr, H);
  }
  __syncthreads();
}

// -- K11: one iteration -------------------------------------------------

template <int R>
struct Mega2Smem {
  static constexpr int nX = kG + 2 * R;  // x window edge (odd)
  static constexpr int sX = nX;
  static constexpr int sW = kG;          // 33: odd
  static constexpr int floats = nX * sX + nX * sW + kG * kG + 64;  // + window overrun
};

template <int R>
__global__ void __launch_bounds__(kThreads)
tv_mega2_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ atb,
                float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                float* __restrict__ partials, int H, int W, R1Taps tp, R1Edges e, PdsParams p) {
  using S = Mega2Smem<R>;
  extern __shared__ float smem[];
  float* X = smem;
  float* Wt = X + S::nX * S::sX;
  float* G = Wt + S::nX * S::sW;
  const int r0 = tile_origin(blockIdx.y, H), c0 = tile_origin(blockIdx.x, W);
  load_window(X, S::sX, x, H, W, r0 - R, c0 - R, S::nX, S::nX);
  __syncthreads();
  gram_region<R, 11, 11>(X, S::sX, Wt, S::sW, G, kG, r0, c0, kG, H, W, tp, e);

  const float* px = X;
  auto xs = [=](int r, int c) { return px[(r - r0 + R) * S::sX + (c - c0 + R)]; };
  const float* pg = G;
  auto grad = [=](int r, int c) {
    return pg[(r - r0) * kG + (c - c0)] - 2.f * __ldg(atb + (size_t)r * W + c);
  };
  auto at = [W](const float* a) {
    return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
  };
  const int rn = blockIdx.y * kTile, cn = blockIdx.x * kTile;  // this block's own pixels
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r < rn || c < cn || r >= H || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, xs, grad, at(z0), at(z1));
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

// -- K14: K11 on a row shard --------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
tv_mega2_shard_kernel(PCT_IMAGE(x), PCT_IMAGE(z0), PCT_IMAGE(z1), PCT_IMAGE(atb),
                      float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                      float* __restrict__ partials, int row0, int hloc, int Rh, int H, int W,
                      R1Taps tp, R1Edges e, PdsParams p) {
  const Shard Xs{xt, x, xb, row0, hloc, Rh, W};
  const Shard Z0{z0t, z0, z0b, row0, hloc, Rh, W};
  const Shard Z1{z1t, z1, z1b, row0, hloc, Rh, W};
  const Shard A{atbt, atb, atbb, row0, hloc, Rh, W};
  using S = Mega2Smem<R>;
  extern __shared__ float smem[];
  float* X = smem;
  float* Wt = X + S::nX * S::sX;
  float* G = Wt + S::nX * S::sW;
  const int r0 = row0 + tile_origin(blockIdx.y, hloc), c0 = tile_origin(blockIdx.x, W);
  load_window(X, S::sX, Xs, H, W, r0 - R, c0 - R, S::nX, S::nX);
  __syncthreads();
  gram_region<R, 11, 11>(X, S::sX, Wt, S::sW, G, kG, r0, c0, kG, H, W, tp, e);

  const float* px = X;
  auto xs = [=](int r, int c) { return px[(r - r0 + R) * S::sX + (c - c0 + R)]; };
  const float* pg = G;
  auto grad = [=](int r, int c) { return pg[(r - r0) * kG + (c - c0)] - 2.f * A(r, c); };
  const int rn = row0 + blockIdx.y * kTile, cn = blockIdx.x * kTile;  // this block's own pixels
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r < rn || c < cn || r >= row0 + hloc || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, xs, grad, Z0, Z1);
    const size_t k = (size_t)(r - row0) * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

// -- K10: two iterations ------------------------------------------------

template <int R>
struct Mega3Smem {
  static constexpr int a = R > 1 ? R : 1;     // stage 1 grows the tile by a
  static constexpr int n1 = kG + 2 * a;       // stage-1 region edge (odd)
  static constexpr int nG1 = n1 + 1;          // stage-1 gradient region
  static constexpr int nX = nG1 + 2 * R;      // x window
  static constexpr int sX = nX | 1;
  static constexpr int sW = nG1 | 1;
  static constexpr int nW2 = kG + 2 * R;      // rows of stage 2's ColGram
  static constexpr int nZ = kTile + 2;        // stage-1 duals: the tile grown by 1
  // [X | W0 | G1 | x1 | z0_1 z1_1]; stage 2's W1 and G2 reuse the space of
  // X, W0 and G1, which stage 1 is done with
  static constexpr int stage1 = nX * sX + nX * sW + nG1 * sW;
  static constexpr int floats = stage1 + n1 * n1 + 2 * nZ * nZ + 64;
  static_assert(nW2 * kG + kG * kG <= stage1, "stage 2's scratch must fit in stage 1's");
};

template <int R>
__global__ void __launch_bounds__(kMega3Threads)
tv_mega3_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ atb,
                float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                float* __restrict__ partials, int H, int W, R1Taps tp, R1Edges e, PdsParams p) {
  using S = Mega3Smem<R>;
  extern __shared__ float smem[];
  float* X = smem;
  float* W0 = X + S::nX * S::sX;
  float* G1 = W0 + S::nX * S::sW;
  float* X1 = G1 + S::nG1 * S::sW;
  float* Z01 = X1 + S::n1 * S::n1;
  float* Z11 = Z01 + S::nZ * S::nZ;
  float* W1 = X;                   // stage 2, after stage 1 is done with X, W0, G1
  float* G2 = X + S::nW2 * kG;
  const int r0 = tile_origin(blockIdx.y, H), c0 = tile_origin(blockIdx.x, W);
  const int o1r = r0 - S::a, o1c = c0 - S::a;  // stage-1 region origin

  // stage 1: the gradient on the stage-1 region grown by 1, then iteration 1
  load_window(X, S::sX, x, H, W, o1r - R, o1c - R, S::nX, S::nX);
  __syncthreads();
  gram_region<R, 8, 8>(X, S::sX, W0, S::sW, G1, S::sW, o1r, o1c, S::nG1, H, W, tp, e);
  {
    const float* px = X;
    auto xs = [=](int r, int c) { return px[(r - o1r + R) * S::sX + (c - o1c + R)]; };
    const float* pg = G1;
    auto grad = [=](int r, int c) {
      return pg[(r - o1r) * S::sW + (c - o1c)] - 2.f * __ldg(atb + (size_t)r * W + c);
    };
    auto at = [W](const float* a) {
      return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
    };
    for (int i = threadIdx.x; i < S::n1 * S::n1; i += blockDim.x) {
      const int r = o1r + i / S::n1, c = o1c + i % S::n1;
      const int zr = r - (r0 - 1), zc = c - (c0 - 1);  // position in the dual zone
      const bool zone = zr >= 0 && zr < S::nZ && zc >= 0 && zc < S::nZ;
      if (r < 0 || r >= H || c < 0 || c >= W) {
        X1[i] = 0.f;
        if (zone) Z01[zr * S::nZ + zc] = Z11[zr * S::nZ + zc] = 0.f;
      } else if (zone) {
        const PdsOut o = pds_stencil(r, c, H, W, p, xs, grad, at(z0), at(z1));
        X1[i] = o.xn;
        Z01[zr * S::nZ + zc] = o.z0n;
        Z11[zr * S::nZ + zc] = o.z1n;
      } else {
        X1[i] = pds_primal(r, c, H, W, p, xs, grad, at(z0), at(z1));
      }
    }
  }
  __syncthreads();

  // stage 2: the gradient of x1 on the tile grown by 1, then iteration 2
  const int off = S::a - R;  // x1's window for stage 2 starts (a - R) into the stage-1 region
  gram_region<R, 11, 11>(X1 + off * S::n1 + off, S::n1, W1, kG, G2, kG, r0, c0, kG, H, W, tp, e);
  const float* px1 = X1;
  const float* pz01 = Z01;
  const float* pz11 = Z11;
  auto mid_x = [=](int r, int c) { return px1[(r - o1r) * S::n1 + (c - o1c)]; };
  auto mid = [=](const float* s) {  // the dual zone, origin (r0 - 1, c0 - 1)
    return [=](int r, int c) { return s[(r - r0 + 1) * S::nZ + (c - c0 + 1)]; };
  };
  const float* pg2 = G2;
  auto grad2 = [=](int r, int c) {
    return pg2[(r - r0) * kG + (c - c0)] - 2.f * __ldg(atb + (size_t)r * W + c);
  };
  const int rn = blockIdx.y * kTile, cn = blockIdx.x * kTile;
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r < rn || c < cn || r >= H || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, mid_x, grad2, mid(pz01), mid(pz11));
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);  // the second iteration against the first
  }
  block_stats<kMega3Threads>(st, partials);
}

// -- K12: the row Gram of a given w, then the stencil ---------------------

template <int R>
struct MegaSmem {
  static constexpr int nW = kG + 2 * R;
  static constexpr int floats = nW * kG + kG * kG + 64;
};

template <int R>
__global__ void __launch_bounds__(kThreads)
tv_mega_kernel(const float* __restrict__ x, const float* __restrict__ z,
               const float* __restrict__ w, const float* __restrict__ atb,
               float* __restrict__ xo, float* __restrict__ zo, int H, int W, R1Taps tp,
               R1Edges e, PdsParams p) {
  using S = MegaSmem<R>;
  extern __shared__ float smem[];
  float* Wt = smem;
  float* G = Wt + S::nW * kG;
  const int r0 = tile_origin(blockIdx.y, H), c0 = tile_origin(blockIdx.x, W);
  // w over rows [r0 - R, r0 + kG + R), zero outside the image (the band's
  // zero boundary), columns [c0, c0 + kG)
  load_window(Wt, kG, w, H, W, r0 - R, c0, S::nW, kG);
  __syncthreads();
  band_along_col<R, 11, true>(Wt, kG, G, kG, kG, kG, tp);
  if (meets_edges(r0, kG, e.Kr, H)) {
    __syncthreads();
    const int Lr = 2 * e.Kr - 2;
    edge_fix(G, kG, 1, r0, kG, kG, Wt, kG, 1, r0 - R, e.E, e.E + (e.Kr - 1) * Lr, e.Kr, H);
  }
  __syncthreads();

  const size_t HW = (size_t)H * W;
  const float* pg = G;
  auto grad = [=](int r, int c) {
    return pg[(r - r0) * kG + (c - c0)] - 2.f * __ldg(atb + (size_t)r * W + c);
  };
  auto at = [W](const float* a) {
    return [a, W](int r, int c) { return __ldg(a + (size_t)r * W + c); };
  };
  const int rn = blockIdx.y * kTile, cn = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = r0 + i / kTile, c = c0 + i % kTile;
    if (r < rn || c < cn || r >= H || c >= W) continue;
    const PdsOut o = pds_stencil(r, c, H, W, p, at(x), grad, at(z), at(z + HW));
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    zo[k] = o.z0n;
    zo[HW + k] = o.z1n;
  }
}

}  // namespace pct

using namespace pct;

namespace {

R1Taps taps_of(const float* taps_host) {
  R1Taps tp;
  std::memcpy(&tp, taps_host, sizeof(tp));
  return tp;
}

template <int R>
int launch_mega2(const float* x, const float* z0, const float* z1, const float* atb, float* xo,
                 float* z0o, float* z1o, float* partials, float* stats, int H, int W,
                 const R1Taps& tp, const R1Edges& e, const PdsParams& p, cudaStream_t s) {
  const size_t bytes = Mega2Smem<R>::floats * sizeof(float);
  cudaError_t err = allow_smem(tv_mega2_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  tv_mega2_kernel<R><<<grid, kThreads, bytes, s>>>(x, z0, z1, atb, xo, z0o, z1o, partials, H, W,
                                                    tp, e, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

// x, z0, z1, atb: {top, core, bottom} pointers of each image.
template <int R>
int launch_mega2_shard(const float* const x[3], const float* const z0[3], const float* const z1[3],
                       const float* const atb[3], float* xo, float* z0o, float* z1o,
                       float* partials, float* stats, int row0, int hloc, int Rh, int H, int W,
                       const R1Taps& tp, const R1Edges& e, const PdsParams& p, cudaStream_t s) {
  const size_t bytes = Mega2Smem<R>::floats * sizeof(float);
  cudaError_t err = allow_smem(tv_mega2_shard_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (hloc + kTile - 1) / kTile);
  tv_mega2_shard_kernel<R><<<grid, kThreads, bytes, s>>>(
      x[0], x[1], x[2], z0[0], z0[1], z0[2], z1[0], z1[1], z1[2], atb[0], atb[1], atb[2], xo, z0o,
      z1o, partials, row0, hloc, Rh, H, W, tp, e, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

template <int R>
int launch_mega3(const float* x, const float* z0, const float* z1, const float* atb, float* xo,
                 float* z0o, float* z1o, float* partials, float* stats, int H, int W,
                 const R1Taps& tp, const R1Edges& e, const PdsParams& p, cudaStream_t s) {
  const size_t bytes = Mega3Smem<R>::floats * sizeof(float);
  cudaError_t err = allow_smem(tv_mega3_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  tv_mega3_kernel<R><<<grid, kMega3Threads, bytes, s>>>(x, z0, z1, atb, xo, z0o, z1o, partials,
                                                         H, W, tp, e, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

template <int R>
int launch_mega(const float* x, const float* z, const float* w, const float* atb, float* xo,
                float* zo, int H, int W, const R1Taps& tp, const R1Edges& e, const PdsParams& p,
                cudaStream_t s) {
  const size_t bytes = MegaSmem<R>::floats * sizeof(float);
  cudaError_t err = allow_smem(tv_mega_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  tv_mega_kernel<R><<<grid, kThreads, bytes, s>>>(x, z, w, atb, xo, zo, H, W, tp, e, p);
  return (int)cudaGetLastError();
}

// The padded reach R (0, 4, 8 or 15) selects the instantiation.
#define PCT_R1_DISPATCH(R, CALL)                 \
  switch (R) {                                   \
    case 0: return CALL(0);                      \
    case 4: return CALL(4);                      \
    case 8: return CALL(8);                      \
    case 15: return CALL(15);                    \
    default: return (int)cudaErrorInvalidValue;  \
  }

}  // namespace

extern "C" {

// taps: 2 * 31 host floats (R1Taps); E: device edge corrections (R1Edges);
// Kr, Kc: the PSF's row and column tap counts; R: the padded reach.
// partials: (grid blocks * 6) scratch; stats: (6,) output.
int pct_tv_mega2(const float* x, const float* z0, const float* z1, const float* atb, float* xo,
                 float* z0o, float* z1o, float* partials, float* stats, int H, int W,
                 const float* taps, const float* E, int Kr, int Kc, int R, float tau, float sigma,
                 float rho, float lam, int nonneg, int iso, void* stream) {
  const R1Taps tp = taps_of(taps);
  const R1Edges e{E, Kr, Kc};
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(RR) launch_mega2<RR>(x, z0, z1, atb, xo, z0o, z1o, partials, stats, H, W, tp, e, p, s)
  PCT_R1_DISPATCH(R, CALL)
#undef CALL
}

// K14: x, z0, z1 are the shard's core (hloc, W) blocks of global rows
// [row0, row0 + hloc) of an (H, W) image, xt, xb, ..., z1b their (Rh, W)
// halo blocks above (t) and below (b), Rh >= R + 1, and atb_ext the
// (hloc + 2 Rh, W) halo-extended atb; the rest as pct_tv_mega2.
int pct_tv_mega2_shard(const float* x, const float* z0, const float* z1, const float* atb_ext,
                       const float* xt, const float* xb, const float* z0t, const float* z0b,
                       const float* z1t, const float* z1b, float* xo, float* z0o, float* z1o,
                       float* partials, float* stats, int row0, int hloc, int Rh, int H, int W,
                       const float* taps, const float* E, int Kr, int Kc, int R, float tau,
                       float sigma, float rho, float lam, int nonneg, int iso, void* stream) {
  const R1Taps tp = taps_of(taps);
  const R1Edges e{E, Kr, Kc};
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t RW = (size_t)Rh * W;
  const float* X[3] = {xt, x, xb};
  const float* Z0[3] = {z0t, z0, z0b};
  const float* Z1[3] = {z1t, z1, z1b};
  const float* A[3] = {atb_ext, atb_ext + RW, atb_ext + RW + (size_t)hloc * W};
#define CALL(RR) \
  launch_mega2_shard<RR>(X, Z0, Z1, A, xo, z0o, z1o, partials, stats, row0, hloc, Rh, H, W, tp, e, p, s)
  PCT_R1_DISPATCH(R, CALL)
#undef CALL
}

// K10; same conventions as pct_tv_mega2: the outputs are the state after two
// iterations, stats those of the second.
int pct_tv_mega3(const float* x, const float* z0, const float* z1, const float* atb, float* xo,
                 float* z0o, float* z1o, float* partials, float* stats, int H, int W,
                 const float* taps, const float* E, int Kr, int Kc, int R, float tau, float sigma,
                 float rho, float lam, int nonneg, int iso, void* stream) {
  const R1Taps tp = taps_of(taps);
  const R1Edges e{E, Kr, Kc};
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(RR) launch_mega3<RR>(x, z0, z1, atb, xo, z0o, z1o, partials, stats, H, W, tp, e, p, s)
  PCT_R1_DISPATCH(R, CALL)
#undef CALL
}

// K12: z and zo are stacked (2, H, W) duals; w = ColGram(x).
int pct_tv_mega(const float* x, const float* z, const float* w, const float* atb, float* xo,
                float* zo, int H, int W, const float* taps, const float* E, int Kr, int Kc, int R,
                float tau, float sigma, float rho, float lam, int nonneg, int iso, void* stream) {
  const R1Taps tp = taps_of(taps);
  const R1Edges e{E, Kr, Kc};
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(RR) launch_mega<RR>(x, z, w, atb, xo, zo, H, W, tp, e, p, s)
  PCT_R1_DISPATCH(R, CALL)
#undef CALL
}

}  // extern "C"
