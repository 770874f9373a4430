// The rank-1 TV engines: one or two full TV primal-dual iterations with the
// exact separable Gram of a rank-1 PSF in its autocorrelation form.
//
//   K11 tv_mega2_kernel  replaces pycsou_tpu/kernels/tv.py tv_pds_mega2_step
//                        (_tv_mega2_kernel, _mega_row_gram, _lane_gram_tile):
//                        one iteration, both Gram directions in the kernel,
//                        with the stopping-metric partial sums.
//   K10 tv_mega3_kernel  replaces tv_pds_mega3_step (_tv_mega3_kernel): two
//                        iterations, the partial sums of the second only;
//                        a block walks a column strip (below).
//   K12 tv_mega_kernel   replaces tv_pds_mega_step (_tv_mega_kernel): the row
//                        Gram of a given w = ColGram(x), then the stencil of
//                        a stacked dual (2, H, W); no partial sums.
//   K14 tv_mega2_shard_kernel  replaces tv_pds_mega2_shard_step (the same
//                        kernel in shard mode): K11's step on a row shard's
//                        core rows, with halo rows from its neighbours, on
//                        staged 32 x 64 tiles (below).
//
// For A = R(u) C(v) the Gram is A^H A = RowGram o ColGram, each the exact
// 1-D 'same'-convolution Gram T^H T: the (2K - 1)-tap autocorrelation band
// (zero boundary) plus dense corrections E_top, E_bot (K - 1 rows of
// L = 2K - 2 taps) on the first and last K - 1 samples of the IMAGE
// (kernels/band.py make_gram_band).  That is two band passes of 2K - 1 taps
// where K4 (tvr.cu) runs four of K taps.  The gradient's 2x is folded into
// the row taps and the row corrections, so g = G x - 2 atb.
//
// Tiles (K11, K12, K14).  Each block owns a 32 x 64 output tile and
// computes the gradient on the tile grown by one row and column (the
// stencil reads x_t one pixel down and right).  The last tile of an axis is
// shifted back to end on the image's edge, so that its windows always hold
// the rows and columns the edge corrections read; such a block writes (and
// sums) only the pixels of its own tile.  The band passes are
// register-blocked: a thread slides a window of NW + 2R values along a row
// (or column) of shared memory and computes NW outputs, with the taps in
// the kernel's parameter space (R, the padded reach, is a template
// parameter: 0, 4, 8 or 15; taps beyond the PSF's reach are 0).  A pass
// down the columns (consecutive threads on consecutive columns) is free of
// bank conflicts at any row stride; a pass along the rows is free of them
// on odd strides (band_along_row) or on strides of 4 x odd floats
// (band_along_row8).
//
// K11 and K12 stage their tiles, as K14 does (below).  Their PR 4 versions
// copied the window a float a thread (a division, four compares and an
// __ldg each), read the stencil's inputs from device memory and computed
// x_t three times a pixel, each phase waiting for the last (K11 0.4966 ms,
// K12 0.3660 at 4096^2 with a 15 x 15 PSF on an H100 SXM at 700 W; staged,
// 0.317 and 0.226).  Now a block resolves each
// row's pointer once into a table in shared memory (ImageRows: nullptr
// outside [0, H), read as 0) and copies by cp.async in two groups: first
// the Gram's window, then x, z0, z1 and atb over the tile grown by one row
// and column each side, which arrive while the band passes run.  K11's x
// window (63 x 95 at R = 15) comes in by 16-byte copies into rows of
// stride 4 x odd for band_along_row8 (K14's, from a shard's halo blocks,
// by 4-byte copies into odd strides); K12's w window (63 x 65) needs only
// the column pass, so it comes in at any stride.  A 16-byte copy is taken
// where the row's 4-float chunk lies inside [0, W) on a 16-byte address
// (every chunk when W % 4 == 0; K12's second dual, at z + H W, only when H
// W % 4 == 0 too), four 4-byte copies with zero fill elsewhere
// (stage_tile).  The stencil runs in two passes from shared memory:
// x_t once a pixel, then pds_update (staged_stencil).  At R = 15 K11 takes
// about 80 KB of shared memory (two blocks an SM), K12 about 65 KB (three).
//
// K10 walks instead of tiling, as the TPU kernel does (its grid walks
// full-width row tiles with rings of rows in VMEM, tv.py:1604-1631).  A
// block owns a strip of kStrip = 64 output columns (the last shifted back
// to end on the image's edge) and a segment of rows (a multiple of the
// step, cut so that the grid fills two blocks an SM about once), and walks
// down it in steps of S = 16 rows.  Step k, with g = g0 + k S:
//   1. stage 1: V = RowGram(x) on rows [g, g + S) down a ring of x rows,
//      G1 = ColGram(V) on the strip grown by A + 1 columns each side, A =
//      max(R, 1) (stage 2 reads the duals one column out of its strip);
//      the Gram's passes in the other order than K11's (the same operator,
//      other rounding); G1 kept with the row above from the last step; then
//      iteration 1 on rows [g - 1, g + S - 1) into a ring of x1 rows (0
//      outside the image's columns: the zero boundary of the second Gram)
//      and, on the strip grown by 1, rings of its duals;
//   2. stage 2, D = R + 1 rows behind: the same on the x1 ring for rows
//      [h, h + S), h = g - D, then iteration 2 on the block's own pixels
//      of rows [h - 1, h + S - 1), with the partial sums.
// After stage 1 the next step's x rows and stage 1's z0, z1, atb rows, and
// stage 2's atb rows, come in by cp.async while stage 2 runs, so no
// stencil reads device memory.  Each stencil runs in two passes: x_t once
// a pixel (into V, free by then), then x' and the duals from it
// (pds_update), where pds_stencil would compute each x_t three times.
// The segment's first steps run stage 1
// alone (the fill); only the strip's sides (A + 1 columns of stage 1, A +
// R + 1 of x) and the segment's ends are computed twice.  Rows outside [0, H)
// are never stored in a ring and read as 0, so once the walk passes the
// image's last row a ring keeps the last rows the bottom edge corrections
// read; segments start on a multiple of S >= R + 1, so the step that
// computes the first K - 1 rows already holds the rows [0, L) the top
// corrections read.  At R = 15: 107 KB of shared memory, two blocks of 256
// threads an SM.
//
// K14 is K11 on a row shard, staged.  Read through sepconv.cuh's Shard, as
// K11's code, its window load and its stencil picked the row's block on
// every read (0.2056 ms a 1024-row shard, 1.66x a quarter of K11).  Now its
// tiles are 32 x 64 output pixels of the shard's core rows [row0, row0 +
// hloc): the last row tile shifted back to end on the core's last row (on
// the image's edge for the last shard, as the edge corrections need), the
// last column tile on the image's.  A block resolves each row's pointer once
// (shard_tile.cuh), copies the x window (63 x 95 at R = 15: 2.9x the tile,
// from 63^2 for 32^2, 3.9x) by 4-byte cp.async into odd-stride rows for the
// band passes, then z0, z1 and atb over the tile grown by one row and column
// each side by 16-byte cp.async in a second group, waited for only after the
// band passes (gram_region, K11's, on a rectangle).  The stencil runs in
// two passes from shared memory: x_t once a pixel, then pds_update.  The x
// window comes from the core and the neighbours' R >= reach + 1 halo rows, 0
// beyond them (values that only reach rows the block does not write); every
// boundary keys to global rows and the global H.  About 80 KB of shared
// memory at R = 15, two blocks an SM.  K11 keeps its own kernel, with a
// 16-byte x window.
//
// Bound by device-memory traffic: 7 image streams for K11 (x, atb, z0, z1
// in; x', z0', z1' out), the same 7 for K10's TWO iterations, 8 for K12
// (w, x, atb, z (2) in; x', z' (2) out).  Halo re-reads come from L2.  The
// outputs go to buffers apart from the inputs (blocks read their
// neighbours' values; the TPU kernels updated in place on an ordered grid).
#include <algorithm>
#include <cstring>

#include "sepconv.cuh"
#include "pds_stencil.cuh"
#include "shard_tile.cuh"

namespace pct {

constexpr int kMaxReach = 15;     // padded reach R <= 15 (taps per axis <= 16)
constexpr int kStrip = 64;       // K10: output columns of a block's strip
constexpr int kMega3Step = 16;   // K10: rows a step of the walk
constexpr int kMega3Threads = 256;

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

// band_along_row<R, NW, false>'s outputs (the column taps along the rows),
// bit for bit, with another thread map, for rows of a stride that is 4
// times an odd number of floats (16-byte rows, K11's x window): a warp
// takes 8 consecutive rows and the row's 4 segments of NW outputs (NW odd,
// ncols <= 4 NW), lane l row l / 4 and segment l % 4.  Its 32 window
// starts, 4 (si / 4) i + NW b plus an offset they share, then lie in 32
// distinct banks: NW b mod 4 tells the segments apart, and si / 4 odd makes
// 4 (si / 4) i distinct mod 32 over 8 rows.  The stores' starts do the same
// when so / 4 is odd.  Reads up to in(i, 4 NW + 2R - 1).
template <int R, int NW>
__device__ __forceinline__ void band_along_row8(const float* in, int si, float* out, int so, int nrows,
                                                int ncols, const R1Taps& tp) {
  static_assert(NW % 2 == 1, "odd segments: their starts differ mod 4");
  for (int it = threadIdx.x; it < (nrows + 7) / 8 * 32; it += blockDim.x) {
    const int i = (it >> 5) * 8 + ((it & 31) >> 2), j0 = (it & 3) * NW;
    if (i >= nrows) continue;
    const float* src = in + i * si + j0;
    float win[NW + 2 * R];
#pragma unroll
    for (int k = 0; k < NW + 2 * R; ++k) win[k] = src[k];
#pragma unroll
    for (int o = 0; o < NW; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t <= 2 * R; ++t) acc = fmaf(tp.ac[t], win[o + t], acc);
      if (j0 + o < ncols) out[i * so + j0 + o] = acc;
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

// G = Gram(x): the exact rank-1 Gram (2x folded into the rows) on the
// region of nGr x nGc pixels at (gr, gc), from X, a window of x over rows
// [gr - R, gr + nGr + R) and columns [gc - R, gc + nGc + R) with stride sx.
// Wt: (nGr + 2R) x nGc scratch for ColGram(x), stride sw; G stride sg.
// The row pass is band_along_row (odd sx) or, with ROW8, band_along_row8
// (sx / 4 odd).  Ends with a block barrier.
template <int R, int NWc, int NWr, bool ROW8 = false>
__device__ __forceinline__ void gram_region(const float* X, int sx, float* Wt, int sw, float* G, int sg,
                                            int gr, int gc, int nGr, int nGc, int H, int W, const R1Taps& tp,
                                            const R1Edges& e) {
  const int nw = nGr + 2 * R;
  if constexpr (ROW8)
    band_along_row8<R, NWc>(X, sx, Wt, sw, nw, nGc, tp);
  else
    band_along_row<R, NWc, false>(X, sx, Wt, sw, nw, nGc, tp);
  if (meets_edges(gc, nGc, e.Kc, W)) {
    __syncthreads();
    const int Lc = 2 * e.Kc - 2, Lr = 2 * e.Kr - 2;
    const float* Etc = e.E + 2 * (e.Kr - 1) * Lr;
    // columns: a = column (stride 1), b = row; X's column 0 is gc - R
    edge_fix(Wt, 1, sw, gc, nGc, nw, X + R, 1, sx, gc, Etc, Etc + (e.Kc - 1) * Lc, e.Kc, W);
  }
  __syncthreads();
  band_along_col<R, NWr, true>(Wt, sw, G, sg, nGr, nGc, tp);
  if (meets_edges(gr, nGr, e.Kr, H)) {
    __syncthreads();
    const int Lr = 2 * e.Kr - 2;
    // rows: a = row (stride sg / sw), b = column; Wt's row 0 is gr - R
    edge_fix(G, sg, 1, gr, nGr, nGc, Wt, sw, 1, gr - R, e.E, e.E + (e.Kr - 1) * Lr, e.Kr, H);
  }
  __syncthreads();
}

// -- K11 and K12: staged 32 x 64 tiles of a dense image -------------------

// The stencil of a staged tile in two passes from shared memory (K11, K12):
// x_t once a pixel of the gradient region (the TR x TC tile at (r0, c0)
// grown by one row and column) into T (stride TC + 1), then pds_update on
// the block's own pixels, each handed to out(r, c, o) (a shifted last tile
// overlaps the one before it: rows below rn and columns left of cn are not
// its own).  xs(r, c) reads x, grad(r, c) the data gradient, zd the duals.
template <int TR, int TC, class FX, class Dual, class FG, class Out>
__device__ __forceinline__ void staged_stencil(float* T, int r0, int c0, int H, int W, const PdsParams& p,
                                               FX xs, const Dual& zd, FG grad, Out out) {
  constexpr int GC = TC + 1;
  for (int i = threadIdx.x; i < (TR + 1) * GC; i += kThreads) {
    const int rr = i / GC, cc = i - rr * GC, r = r0 + rr, c = c0 + cc;
    if (r < H && c < W) T[i] = zd.x_t(r, c, xs(r, c), grad, p);
  }
  __syncthreads();
  const int rn = blockIdx.y * TR, cn = blockIdx.x * TC;
  for (int i = threadIdx.x; i < TR * TC; i += kThreads) {
    const int rr = i / TC, cc = i % TC, r = r0 + rr, c = c0 + cc;
    if (r < rn || c < cn || r >= H || c >= W) continue;
    const float* t = T + rr * GC + cc;
    const bool down = r < H - 1, right = c < W - 1;
    out(r, c, pds_update(r, c, H, W, p, zd, xs(r, c), t[0], down ? xs(r + 1, c) : 0.f, down ? t[GC] : 0.f,
                         right ? xs(r, c + 1) : 0.f, right ? t[1] : 0.f));
  }
}

// K11's geometry for padded reach R: a tile of TR x TC output pixels, the
// gradient on the tile grown by one row and column (GR x GC), the x window
// over it grown by R each side: rows [r0 - R, r0 + GR + R), columns from
// cx = c0 - R rounded down to a multiple of 4, NKx 16-byte chunks a row
// (NKx odd: band_along_row8's stride; ColGram(x)'s rows Wt likewise get
// 4 x odd floats, for its stores); z0, z1 and atb staged over rows [r0 - 1,
// r0 + TR] and columns [cs, cs + TC + 8), cs = c0 - 1 rounded down to 4 (the
// stencil reads [c0 - 1, c0 + TC]), as K14's.  Shared memory: the row
// table, then [z0, z1, atb | x window | Wt (ColGram(x), later x_t) | G].
// At R = 15 about 80 KB: two blocks an SM.
template <int R>
struct Mega2Tile {
  static constexpr int TR = kTile, TC = 64;
  static constexpr int GR = TR + 1, GC = TC + 1;
  static constexpr int NXr = GR + 2 * R, NXc = GC + 2 * R;
  static constexpr int NKx = (NXc + 3 + 3) / 4 | 1;  // chunks from cx: [c0 - R, c0 + GC + R) and up to 3 before
  static constexpr int sX = 4 * NKx, sW = 4 * ((GC + 3) / 4 | 1);
  static constexpr int NR = TR + 2, NK = TC / 4 + 2, sI = 4 * NK, nI = NR * sI;
  static constexpr int NWc = 17, NWr = 11;  // row pass: a window row's 4 segments; column pass: 3 a column
  static constexpr int ptrs = NXr + 3 * NR, ptr_bytes = (ptrs * (int)sizeof(const float*) + 15) / 16 * 16;
  static constexpr int oX = 3 * nI;
  static constexpr int oW = oX + NXr * sX + 4;  // + the row pass's overrun past the last row
  static constexpr int oG = oW + NXr * sW;
  static constexpr size_t bytes = ptr_bytes + (size_t)(oG + GR * GC) * sizeof(float);
  static_assert(GC <= 4 * NWc && (GR + NWr - 1) / NWr * NWr == GR, "a row's 4 segments; 3 a column");
  static_assert(3 + 4 * NWc + 2 * R - sX <= 4, "the row pass's overrun");
  static_assert(ptrs <= kThreads && GR * GC <= NXr * sW, "one pointer a thread; x_t fits in Wt");
};

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tv_mega2_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ atb,
                float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                float* __restrict__ partials, int H, int W, R1Taps tp, R1Edges e, PdsParams p) {
  using S = Mega2Tile<R>;
  extern __shared__ float4 smem4[];
  const float** rows = reinterpret_cast<const float**>(smem4);
  float* In = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + S::ptr_bytes);  // z0, z1, atb
  float* X = In + S::oX;
  float* Wt = In + S::oW;
  float* G = In + S::oG;
  const int r0 = span_origin(blockIdx.y, S::TR, H), c0 = span_origin(blockIdx.x, S::TC, W);
  const int cs = (c0 - 1) & ~3, cx = (c0 - R) & ~3;
  // row pointers, once a row: x's window rows r0 - R + i at i, then image a's
  // (z0, z1, atb) staged rows r0 - 1 + i at NXr + a * NR + i
  if (threadIdx.x < S::ptrs) {
    const int t = threadIdx.x, a = t < S::NXr ? -1 : (t - S::NXr) / S::NR;
    const ImageRows src{a < 0 ? x : a == 0 ? z0 : a == 1 ? z1 : atb, H, W};
    rows[t] = src.row(a < 0 ? r0 - R + t : r0 - 1 + (t - S::NXr - a * S::NR));
  }
  __syncthreads();
  // the x window first, then the stencil's inputs, which arrive during the band passes
  stage_tile<S::NXr, S::NKx, kThreads>(X, S::sX, rows, cx, W);
  copy_commit();
#pragma unroll
  for (int a = 0; a < 3; ++a)
    stage_tile<S::NR, S::NK, kThreads>(In + a * S::nI, S::sI, rows + S::NXr + a * S::NR, cs, W);
  copy_commit();
  copy_wait_group<1>();
  __syncthreads();
  const float* Xw = X + (c0 - R - cx);  // x at (r0 - R, c0 - R)
  gram_region<R, S::NWc, S::NWr, true>(Xw, S::sX, Wt, S::sW, G, S::GC, r0, c0, S::GR, S::GC, H, W, tp, e);
  copy_wait_group<0>();
  __syncthreads();

  auto in = [&](int a) {
    const float* b = In + a * S::nI;
    return [=](int r, int c) { return b[(r - r0 + 1) * S::sI + (c - cs)]; };
  };
  const auto A = in(2);
  const MaskedDual<decltype(in(0)), decltype(in(1))> zd{in(0), in(1), H, W};
  auto grad = [=](int r, int c) { return G[(r - r0) * S::GC + (c - c0)] - 2.f * A(r, c); };
  const float* Xc = Xw + R * S::sX + R;  // x at the tile's origin
  auto xs = [=](int r, int c) { return Xc[(r - r0) * S::sX + (c - c0)]; };
  Stats6 st;
  st.zero();
  staged_stencil<S::TR, S::TC>(Wt, r0, c0, H, W, p, xs, zd, grad, [&](int r, int c, const PdsOut& o) {
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  });
  block_stats(st, partials);
}

// -- K14: K11 on a row shard, from staged tiles -------------------------

// K14's geometry for padded reach R: a tile of TR x TC output pixels of
// the core, the gradient on the tile grown by one row and column (GR x
// GC), the x window over it grown by R each side (odd stride, for the band
// passes), and z0, z1 and atb staged over rows [r0 - 1, r0 + TR] and
// columns [cs, cs + TC + 8), cs = c0 - 1 rounded down to a multiple of 4
// (16-byte chunks; the stencil reads [c0 - 1, c0 + TC]).  Shared memory:
// the row table, then [z0, z1, atb | x window | Wt (ColGram(x), later
// x_t) | G].  At R = 15 about 80 KB: two blocks an SM.
template <int R>
struct Mega2ShardSmem {
  static constexpr int TR = kTile, TC = 64;
  static constexpr int GR = TR + 1, GC = TC + 1;
  static constexpr int NXr = GR + 2 * R, NXc = GC + 2 * R, sX = NXc | 1, sW = GC | 1;
  static constexpr int NR = TR + 2, NK = TC / 4 + 2, sI = 4 * NK, nI = NR * sI;
  static constexpr int NWc = 17, NWr = 11;  // band pass items: 4 a window row, 3 a column
  static constexpr int ptrs = NXr + 3 * NR, ptr_bytes = (ptrs * (int)sizeof(const float*) + 15) / 16 * 16;
  static constexpr int oX = 3 * nI;
  static constexpr int oW = oX + NXr * sX + 4;  // + the row pass's overrun: (GC + NWc - 1) / NWc * NWc - GC
  static constexpr int oG = oW + NXr * sW;
  static constexpr size_t bytes = ptr_bytes + (size_t)(oG + GR * GC) * sizeof(float);
  static_assert((GC + NWc - 1) / NWc * NWc - GC <= 4 && (GR + NWr - 1) / NWr * NWr == GR, "pass overruns");
  static_assert(ptrs <= kThreads, "one pointer a thread");
};

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tv_mega2_shard_kernel(PCT_IMAGE(x), PCT_IMAGE(z0), PCT_IMAGE(z1), PCT_IMAGE(atb),
                      float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                      float* __restrict__ partials, int row0, int hloc, int Rh, int H, int W,
                      R1Taps tp, R1Edges e, PdsParams p) {
  using S = Mega2ShardSmem<R>;
  extern __shared__ float4 smem4[];
  const float** rows = reinterpret_cast<const float**>(smem4);
  float* In = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + S::ptr_bytes);  // z0, z1, atb
  float* X = In + S::oX;
  float* Wt = In + S::oW;
  float* G = In + S::oG;
  const int r0 = row0 + span_origin(blockIdx.y, kTile, hloc), c0 = span_origin(blockIdx.x, S::TC, W);
  const int cs = (c0 - 1) & ~3;
  // row pointers, once a row: x's window rows r0 - R + i at i, then image a's
  // (z0, z1, atb) staged rows r0 - 1 + i at NXr + a * NR + i
  if (threadIdx.x < S::ptrs) {
    const int t = threadIdx.x, a = t < S::NXr ? -1 : (t - S::NXr) / S::NR;
    const ShardRows src{a < 0 ? xt : a == 0 ? z0t : a == 1 ? z1t : atbt, a < 0 ? x : a == 0 ? z0 : a == 1 ? z1 : atb,
                        a < 0 ? xb : a == 0 ? z0b : a == 1 ? z1b : atbb, row0, hloc, Rh, H, W};
    rows[t] = src.row(a < 0 ? r0 - R + t : r0 - 1 + (t - S::NXr - a * S::NR));
  }
  __syncthreads();
  // the x window first, then the stencil's inputs, which arrive during the band passes
  stage_window<kThreads>(X, S::sX, S::NXr, S::NXc, rows, c0 - R, W);
  copy_commit();
#pragma unroll
  for (int a = 0; a < 3; ++a)
    stage_tile<S::NR, S::NK, kThreads>(In + a * S::nI, S::sI, rows + S::NXr + a * S::NR, cs, W);
  copy_commit();
  copy_wait_group<1>();
  __syncthreads();
  gram_region<R, S::NWc, S::NWr>(X, S::sX, Wt, S::sW, G, S::GC, r0, c0, S::GR, S::GC, H, W, tp, e);
  copy_wait_group<0>();
  __syncthreads();

  auto in = [&](int a) {
    const float* b = In + a * S::nI;
    return [=](int r, int c) { return b[(r - r0 + 1) * S::sI + (c - cs)]; };
  };
  const auto A = in(2);
  const MaskedDual<decltype(in(0)), decltype(in(1))> zd{in(0), in(1), H, W};
  auto grad = [=](int r, int c) { return G[(r - r0) * S::GC + (c - c0)] - 2.f * A(r, c); };
  const float* Xc = X + R * S::sX + R;  // x at the tile's origin
  // pass 1: x_t once a pixel on the gradient region, into Wt (free now)
  float* T = Wt;
  for (int i = threadIdx.x; i < S::GR * S::GC; i += kThreads) {
    const int rr = i / S::GC, cc = i - (i / S::GC) * S::GC, r = r0 + rr, c = c0 + cc;
    if (r >= H || r > row0 + hloc || c >= W) continue;
    T[i] = zd.x_t(r, c, Xc[rr * S::sX + cc], grad, p);
  }
  __syncthreads();
  // pass 2: the update of this block's own pixels (a shifted last tile
  // overlaps the one before it: rows below rn, columns left of cn are not
  // its own)
  const int rn = row0 + blockIdx.y * kTile, cn = blockIdx.x * S::TC;
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < S::TR * S::TC; i += kThreads) {
    const int rr = i / S::TC, cc = i % S::TC, r = r0 + rr, c = c0 + cc;
    if (r < rn || c < cn || r >= row0 + hloc || c >= W) continue;
    const float* xp = Xc + rr * S::sX + cc;
    const float* t = T + rr * S::GC + cc;
    const bool down = r < H - 1, right = c < W - 1;
    const PdsOut o = pds_update(r, c, H, W, p, zd, xp[0], t[0], down ? xp[S::sX] : 0.f, down ? t[S::GC] : 0.f,
                                right ? xp[1] : 0.f, right ? t[1] : 0.f);
    const size_t k = (size_t)(r - row0) * W + c;
    xo[k] = o.xn;
    z0o[k] = o.z0n;
    z1o[k] = o.z1n;
    st.add(o);
  }
  block_stats(st, partials);
}

// -- K10: two iterations ------------------------------------------------

// The strip walker's geometry for padded reach R (the design is in the
// comment at the top of this file).  Columns are relative to the strip's
// first output column c0, rows are global.
template <int R>
struct Mega3Geom {
  static constexpr int S = kMega3Step;       // rows a step
  static constexpr int D = R + 1;            // lag: stage 1 behind x, stage 2 behind stage 1
  static constexpr int Rx = R > 1 ? R : 1;   // x rows kept above a step's first gradient row
  static constexpr int R2 = R > 2 ? R : 2;   // x1 rows kept above stage 2's first gradient row
  // stage 1 grows the strip by A columns each side: R for stage 2's Gram,
  // and at least 1 for the duals stage 2 reads one column out (R = 0)
  static constexpr int A = R > 1 ? R : 1;
  static constexpr int N1 = kStrip + 2 * A + 1;  // x1: columns [-A, Cw + A]
  static constexpr int NG = N1 + 1;          // G1: columns [-A, Cw + A + 1]
  static constexpr int NXc = NG + 2 * R;     // x: columns [-A - R, Cw + A + R + 1]
  static constexpr int NZc = kStrip + 2;     // stage-1 duals: columns [-1, Cw]
  static constexpr int N2 = kStrip + 1;      // G2 and stage 2's atb: columns [0, Cw]
  static constexpr int NI = N1 + 2;          // stage 1's z0, z1, atb: columns [-A - 1, Cw + A + 1]
  static constexpr int NX = S + R + Rx;      // rows of the x ring
  static constexpr int NX1 = S + R + R2;     // rows of the x1 ring
  static constexpr int NZ = S + R + 2;       // rows of the stage-1 dual rings
  static constexpr int sX = NXc | 1, sG = NG | 1, s1 = N1 | 1, sZ = NZc | 1, s2 = N2 | 1, sI = NI | 1;
  static constexpr int K2 = (D + R2 + S - 1) / S;  // stage-1 steps before stage 2's first (at least)
  // [x ring | V | G1 | x1 ring | z0_1 ring | z1_1 ring | G2 | stage 1's
  // z0, z1, atb (rows [g - 2, g + S)) | stage 2's atb (rows [h - 1, h + S),
  // two buffers)]; V holds in turn stage 1's row pass, its x_t ((S + 1)
  // rows of stride s1), stage 2's row pass and its x_t (stride s2)
  static constexpr int nV = S * sX > (S + 1) * s1 ? S * sX : (S + 1) * s1;
  static constexpr int oV = NX * sX, oG1 = oV + nV, oX1 = oG1 + (S + 1) * sG;
  static constexpr int oZ0 = oX1 + NX1 * s1, oZ1 = oZ0 + NZ * sZ, oG2 = oZ1 + NZ * sZ;
  static constexpr int nI = (S + 2) * sI, oI = oG2 + (S + 1) * s2, nA2 = (S + 1) * s2, oA2 = oI + 3 * nI;
  static constexpr int floats = oA2 + 2 * nA2;
  static_assert(S * s1 + A + R + kNW <= nV && (S + 1) * s2 <= nV, "V2 (and its row pass's overrun) must fit in V");
  static_assert(S >= R + 1 && S % kNW == 0, "a step covers the edge corrections' reach");
};

// A ring of N image rows in shared memory: row q sits at slot (q - q0) mod
// N, stride s; rows outside [0, H) read as 0 and are never stored, so the
// ring keeps the image's last N rows once the walk passes H.  at(lo) gives
// the ring for a step whose rows lie within (lo - N, lo + 2N) (the window
// [lo, lo + N) and, below it, the last rows the bottom edge corrections
// read), where a slot costs an add and a compare, no division.
template <int N>
struct RowRing {
  float* p;
  int q0, s, H;
  int lo = 0, base = 0;  // base: the slot of row lo
  __device__ __forceinline__ RowRing at(int l) const {
    RowRing r = *this;
    r.lo = l;
    r.base = (l - q0) % N;
    if (r.base < 0) r.base += N;
    return r;
  }
  __device__ __forceinline__ int slot(int q) const {
    const int t = q - lo + base;
    return t < 0 ? t + N : t >= N ? t - N : t;
  }
  __device__ __forceinline__ float* row(int q) const { return p + slot(q) * s; }
  __device__ __forceinline__ bool held(int q) const { return q >= 0 && q < H; }
};

// out(i, j) = sum_t ar[t] ring(q + i + t - R, j) for i < S, j < ncols: the
// row band pass down a ring, a thread computing NW consecutive rows of one
// column from a register window (consecutive threads take consecutive
// columns: no bank conflicts).
template <int R, int NW, int S, int N>
__device__ __forceinline__ void band_down_ring(const RowRing<N>& in, int q, float* out, int so, int ncols,
                                               const R1Taps& tp) {
  for (int it = threadIdx.x; it < ncols * (S / NW); it += blockDim.x) {
    const int j = it % ncols, i0 = (it / ncols) * NW;
    const int qa = q + i0 - R;
    int sl = in.slot(qa);
    float win[NW + 2 * R];
#pragma unroll
    for (int k = 0; k < NW + 2 * R; ++k) {
      win[k] = in.held(qa + k) ? in.p[sl * in.s + j] : 0.f;
      sl = sl + 1 == N ? 0 : sl + 1;
    }
#pragma unroll
    for (int o = 0; o < NW; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t <= 2 * R; ++t) acc = fmaf(tp.ar[t], win[o + t], acc);
      out[(i0 + o) * so + j] = acc;
    }
  }
}

// The row edge corrections (edge_fix's rows) of a band pass down a ring:
// out row i is image row q + i (i < n), columns j < ncols; rows
// [0, K - 1) read ring rows [0, L), rows [H - K + 1, H) ring rows
// [H - L, H), which the ring must hold.
template <int N>
__device__ __forceinline__ void ring_row_fix(float* out, int so, int q, int n, int ncols, const RowRing<N>& in,
                                             const float* __restrict__ Et, const float* __restrict__ Eb,
                                             int K, int H) {
  if (K <= 1) return;
  const int k1 = K - 1, L = 2 * K - 2;
  const int t0 = max(0, -q), t1 = min(n, k1 - q);
  const int b0 = max(0, H - k1 - q), b1 = min(n, H - q);
  const int nt = max(0, t1 - t0), nbot = max(0, b1 - b0);
  for (int it = threadIdx.x; it < (nt + nbot) * ncols; it += blockDim.x) {
    const int e = it / ncols, j = it - e * ncols;
    const bool top = e < nt;
    const int i = top ? t0 + e : b0 + e - nt;
    const int g = q + i;
    const float* row = top ? Et + g * L : Eb + (g - (H - k1)) * L;
    const int qs = top ? 0 : H - L;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(__ldg(row + l), in.held(qs + l) ? in.row(qs + l)[j] : 0.f, acc);
    out[i * so + j] += acc;
  }
}

// Copy of image rows [qa, qb) of an (H, W) image, columns [cx, cx + nc),
// to dst(q) in shared memory by cp.async (0 outside the image's columns;
// rows outside [0, H) skipped).  A warp copies a row at a time.  Done after
// copy_wait().
template <class Dst>
__device__ __forceinline__ void rows_load(Dst dst, const float* __restrict__ src, int H, int W, int qa, int qb,
                                          int cx, int nc) {
  const int lane = threadIdx.x & 31;
  for (int q = max(qa, 0) + (int)(threadIdx.x >> 5); q < min(qb, H); q += blockDim.x >> 5) {
    float* d = dst(q);
    const float* row = src + (size_t)q * W;
    for (int cc = lane; cc < nc; cc += 32) {
      const int c = cx + cc;
      const bool in = c >= 0 && c < W;
      copy_async(d + cc, row + (in ? c : 0), in);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMega3Threads, 2)
tv_mega3_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ atb,
                float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                float* __restrict__ partials, int H, int W, int Hs, R1Taps tp, R1Edges e, PdsParams p) {
  using G = Mega3Geom<R>;
  constexpr int S = G::S;
  extern __shared__ float smem[];
  float* V = smem + G::oV;
  float* G1 = smem + G::oG1;
  float* G2 = smem + G::oG2;
  const int c0 = span_origin(blockIdx.x, kStrip, W), cn = blockIdx.x * kStrip;  // cn: first own column
  const int ce = min(cn + kStrip, W);
  const int r0 = blockIdx.y * Hs, r1 = min(r0 + Hs, H);                   // own rows [r0, r1)
  // stage-1 steps before stage 2's first: G::K2, or more where the segment
  // ends less than 2R rows below its start, so that stage 1 makes the x1
  // rows [H - L, H) the last rows' edge corrections read
  const int K2 = max(G::K2, (r0 + G::D - H + 2 * R + S - 1) / S);
  const int g0 = r0 + G::D - K2 * S;  // step k: stage 1's gradient rows [g, g + S), g = g0 + kS
  const int nsteps = K2 + (r1 - r0 + S) / S;
  const RowRing<G::NX> Xr{smem, g0 - G::Rx, G::sX, H};
  const RowRing<G::NX1> X1r{smem + G::oX1, g0 - 1, G::s1, H};
  const RowRing<G::NZ> Z0r{smem + G::oZ0, g0 - 1, G::sZ, H}, Z1r{smem + G::oZ1, g0 - 1, G::sZ, H};
  const int Lr = 2 * e.Kr - 2, Lc = 2 * e.Kc - 2;
  const float* Etc = e.E + 2 * (e.Kr - 1) * Lr;
  const float* Ebc = Etc + (e.Kc - 1) * Lc;
  constexpr int A = G::A;
  const bool cols1 = meets_edges(c0 - A, G::NG, e.Kc, W), cols2 = meets_edges(c0, G::N2, e.Kc, W);
  float* In = smem + G::oI;  // stage 1's z0, z1, atb: row g - 2 + i, column c0 - A - 1 + j
  // the rows step k reads of x and of stage 1's inputs; stage 2's atb for
  // step k goes into buffer k & 1
  auto load_stage1 = [&](int g) {
    const auto X = Xr.at(g - G::Rx);
    rows_load([&](int q) { return X.row(q); }, x, H, W, g + R, g + S + R, c0 - A - R, G::NXc);
    const float* srcs[3] = {z0, z1, atb};
    for (int a = 0; a < 3; ++a)
      rows_load([&](int q) { return In + a * G::nI + (q - g + 2) * G::sI; }, srcs[a], H, W, g - 2, g + S,
                c0 - A - 1, G::NI);
  };
  auto load_stage2 = [&](int h, int buf) {
    float* A2 = smem + G::oA2 + buf * G::nA2;
    rows_load([&](int q) { return A2 + (q - h + 1) * G::s2; }, atb, H, W, h - 1, h + S, c0, G::N2);
  };
  Stats6 st;
  st.zero();

  {
    const auto X = Xr.at(g0 - G::Rx);
    rows_load([&](int q) { return X.row(q); }, x, H, W, g0 - G::Rx, g0 + R, c0 - A - R, G::NXc);
  }
  load_stage1(g0);
  for (int k = 0; k < nsteps; ++k) {
    const int g = g0 + k * S;
    // this step's windows of the rings: x rows [g - Rx, g + S + R); x1 rows
    // and stage-1 duals from stage 2's first read to stage 1's last write
    const auto X = Xr.at(g - G::Rx);
    const auto X1 = X1r.at(g + S - 1 - G::NX1);
    const auto Z0 = Z0r.at(g + S - 1 - G::NZ), Z1 = Z1r.at(g + S - 1 - G::NZ);
    copy_wait();
    __syncthreads();  // this step's x rows are in; the last step is done with every buffer
    // stage 1: V = RowGram(x) on rows [g, g + S), G1 = ColGram(V), kept with
    // the row above (the last step's last, slot 0); then iteration 1 on
    // rows [g - 1, g + S - 1)
    for (int j = threadIdx.x; j < G::NG; j += kMega3Threads) G1[j] = G1[S * G::sG + j];
    band_down_ring<R, kNW, S>(X, g, V, G::sX, G::NXc, tp);
    if (meets_edges(g, S, e.Kr, H)) {
      __syncthreads();
      ring_row_fix(V, G::sX, g, S, G::NXc, X, e.E, e.E + (e.Kr - 1) * Lr, e.Kr, H);
    }
    __syncthreads();
    band_along_row<R, kNW, false>(V, G::sX, G1 + G::sG, G::sG, S, G::NG, tp);
    if (cols1) {
      __syncthreads();
      edge_fix(G1 + G::sG, 1, G::sG, c0 - A, G::NG, S, V, 1, G::sX, c0 - A - R, Etc, Ebc, e.Kc, W);
    }
    __syncthreads();
    {
      // iteration 1 in two passes: x_t once a pixel on rows [g - 1, g + S]
      // into T (V is free), then x1 and, on the dual columns, the duals
      float* T = V;  // row r - g + 1, column c - c0 + A
      auto xs = [=](int r, int c) { return X.row(r)[c - c0 + A + R]; };
      auto in = [=](int a) {
        return [=](int r, int c) { return In[a * G::nI + (r - g + 2) * G::sI + (c - c0 + A + 1)]; };
      };
      const auto ia = in(2);
      const MaskedDual<decltype(in(0)), decltype(in(1))> zd{in(0), in(1), H, W};
      auto grad = [=](int r, int c) { return G1[(r - g + 1) * G::sG + (c - c0 + A)] - 2.f * ia(r, c); };
      for (int i = threadIdx.x; i < (S + 1) * G::N1; i += kMega3Threads) {
        const int rr = i / G::N1, cc = i % G::N1, r = g - 1 + rr, c = c0 - A + cc;
        if (r >= 0 && r < H && c >= 0 && c < W) T[rr * G::s1 + cc] = zd.x_t(r, c, xs(r, c), grad, p);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < S * G::N1; i += kMega3Threads) {
        const int rr = i / G::N1, cc = i % G::N1, r = g - 1 + rr, c = c0 - A + cc;
        if (r < 0 || r >= H) continue;
        float* x1 = X1.row(r) + cc;
        if (c < 0 || c >= W) {
          *x1 = 0.f;
          continue;
        }
        const float* t = T + rr * G::s1 + cc;
        const float x0 = xs(r, c);
        const int zc = c - c0 + 1;  // column in the dual rings
        if (zc < 0 || zc >= G::NZc) {
          *x1 = p.rho * t[0] + (1.f - p.rho) * x0;
          continue;
        }
        const bool down = r < H - 1, right = c < W - 1;
        const PdsOut o = pds_update(r, c, H, W, p, zd, x0, t[0], down ? xs(r + 1, c) : 0.f,
                                    down ? t[G::s1] : 0.f, right ? xs(r, c + 1) : 0.f, right ? t[1] : 0.f);
        *x1 = o.xn;
        Z0.row(r)[zc] = o.z0n;
        Z1.row(r)[zc] = o.z1n;
      }
    }
    __syncthreads();
    // stage 1's buffers are free: the next step's rows come in while stage 2 runs
    if (k + 1 < nsteps) {
      load_stage1(g + S);
      if (k + 1 >= K2) load_stage2(g + S - G::D, (k + 1) & 1);
    }
    if (k < K2) continue;

    // stage 2, D rows behind: the same on x1 for rows [h, h + S), then
    // iteration 2 on the block's own rows among [h - 1, h + S - 1)
    const int h = g - G::D;
    for (int j = threadIdx.x; j < G::N2; j += kMega3Threads) G2[j] = G2[S * G::s2 + j];
    band_down_ring<R, kNW, S>(X1, h, V, G::s1, G::N1, tp);
    if (meets_edges(h, S, e.Kr, H)) {
      __syncthreads();
      ring_row_fix(V, G::s1, h, S, G::N1, X1, e.E, e.E + (e.Kr - 1) * Lr, e.Kr, H);
    }
    __syncthreads();
    band_along_row<R, kNW, false>(V + (A - R), G::s1, G2 + G::s2, G::s2, S, G::N2, tp);  // from column c0 - R
    if (cols2) {
      __syncthreads();
      edge_fix(G2 + G::s2, 1, G::s2, c0, G::N2, S, V, 1, G::s1, c0 - A, Etc, Ebc, e.Kc, W);
    }
    __syncthreads();
    // iteration 2 in the same two passes: x_t on rows [h - 1, h + S) and
    // columns [c0, c0 + Cw] into T, then the block's own pixels
    float* T = V;  // row r - h + 1, column c - c0
    auto mid_x = [=](int r, int c) { return X1.row(r)[c - c0 + A]; };
    auto mid = [=](const RowRing<G::NZ>& z) {
      return [=](int r, int c) { return z.row(r)[c - c0 + 1]; };
    };
    const MaskedDual<decltype(mid(Z0)), decltype(mid(Z1))> zd{mid(Z0), mid(Z1), H, W};
    const float* A2 = smem + G::oA2 + (k & 1) * G::nA2;  // atb, rows [h - 1, h + S)
    auto grad2 = [=](int r, int c) {
      const int o = (r - h + 1) * G::s2 + (c - c0);
      return G2[o] - 2.f * A2[o];
    };
    for (int i = threadIdx.x; i < (S + 1) * G::N2; i += kMega3Threads) {
      const int rr = i / G::N2, cc = i % G::N2, r = h - 1 + rr, c = c0 + cc;
      if (r >= 0 && r < H && c < W) T[rr * G::s2 + cc] = zd.x_t(r, c, mid_x(r, c), grad2, p);
    }
    __syncthreads();
    const int ra = max(h - 1, r0), rb = min(h + S - 1, r1);
    for (int i = threadIdx.x; i < (rb - ra) * kStrip; i += kMega3Threads) {
      const int r = ra + i / kStrip, cc = i % kStrip, c = c0 + cc;
      if (c < cn || c >= ce) continue;
      const float* t = T + (r - h + 1) * G::s2 + cc;
      const bool down = r < H - 1, right = c < W - 1;
      const PdsOut o = pds_update(r, c, H, W, p, zd, mid_x(r, c), t[0], down ? mid_x(r + 1, c) : 0.f,
                                  down ? t[G::s2] : 0.f, right ? mid_x(r, c + 1) : 0.f, right ? t[1] : 0.f);
      const size_t q = (size_t)r * W + c;
      xo[q] = o.xn;
      z0o[q] = o.z0n;
      z1o[q] = o.z1n;
      st.add(o);  // the second iteration against the first
    }
  }
  block_stats<kMega3Threads>(st, partials);
}

// -- K12: the row Gram of a given w, then the stencil ---------------------

// K12's geometry for padded reach R: K11's tiles, the w window over rows
// [r0 - R, r0 + GR + R) and columns [cw, cw + TC + 4), cw = c0 rounded down
// to a multiple of 4 (the column pass's consecutive threads take
// consecutive columns: any stride is free of bank conflicts), then x, z's
// two halves and atb staged as K11's z0, z1 and atb.  Shared memory: the
// row table, then [x, z0, z1, atb | w window (later x_t) | G].  At R = 15
// about 65 KB: three blocks an SM.
template <int R>
struct MegaTile {
  static constexpr int TR = kTile, TC = 64;
  static constexpr int GR = TR + 1, GC = TC + 1;
  static constexpr int Nw = GR + 2 * R, NKw = TC / 4 + 1, sw = 4 * NKw;
  static constexpr int NR = TR + 2, NK = TC / 4 + 2, sI = 4 * NK, nI = NR * sI;
  static constexpr int NWr = 11;  // column pass: 3 items a column
  static constexpr int ptrs = Nw + 4 * NR, ptr_bytes = (ptrs * (int)sizeof(const float*) + 15) / 16 * 16;
  static constexpr int oW = 4 * nI, oG = oW + Nw * sw;
  static constexpr size_t bytes = ptr_bytes + (size_t)(oG + GR * GC) * sizeof(float);
  static_assert((GR + NWr - 1) / NWr * NWr == GR && GC + 3 <= sw, "the column pass stays in the window");
  static_assert(ptrs <= kThreads && GR * GC <= Nw * sw, "one pointer a thread; x_t fits in the w window");
};

template <int R>
__global__ void __launch_bounds__(kThreads, 3)
tv_mega_kernel(const float* __restrict__ x, const float* __restrict__ z,
               const float* __restrict__ w, const float* __restrict__ atb,
               float* __restrict__ xo, float* __restrict__ zo, int H, int W, R1Taps tp,
               R1Edges e, PdsParams p) {
  using S = MegaTile<R>;
  extern __shared__ float4 smem4[];
  const float** rows = reinterpret_cast<const float**>(smem4);
  float* In = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + S::ptr_bytes);  // x, z0, z1, atb
  float* Wn = In + S::oW;
  float* G = In + S::oG;
  const int r0 = span_origin(blockIdx.y, S::TR, H), c0 = span_origin(blockIdx.x, S::TC, W);
  const int cs = (c0 - 1) & ~3, cw = c0 & ~3;
  const size_t HW = (size_t)H * W;
  // row pointers, once a row: w's window rows r0 - R + i at i, then image a's
  // (x, z0 = z, z1 = z + HW, atb) staged rows r0 - 1 + i at Nw + a * NR + i
  if (threadIdx.x < S::ptrs) {
    const int t = threadIdx.x, a = t < S::Nw ? -1 : (t - S::Nw) / S::NR;
    const ImageRows src{a < 0 ? w : a == 0 ? x : a == 1 ? z : a == 2 ? z + HW : atb, H, W};
    rows[t] = src.row(a < 0 ? r0 - R + t : r0 - 1 + (t - S::Nw - a * S::NR));
  }
  __syncthreads();
  // the w window first, then the stencil's inputs, which arrive during the band pass
  stage_tile<S::Nw, S::NKw, kThreads>(Wn, S::sw, rows, cw, W);
  copy_commit();
#pragma unroll
  for (int a = 0; a < 4; ++a)
    stage_tile<S::NR, S::NK, kThreads>(In + a * S::nI, S::sI, rows + S::Nw + a * S::NR, cs, W);
  copy_commit();
  copy_wait_group<1>();
  __syncthreads();
  // G = RowGram(w) on the gradient region: the band pass down the columns,
  // then the row edge corrections (the window holds the rows they read)
  const float* Wc = Wn + (c0 - cw);  // w at (r0 - R, c0)
  band_along_col<R, S::NWr, true>(Wc, S::sw, G, S::GC, S::GR, S::GC, tp);
  if (meets_edges(r0, S::GR, e.Kr, H)) {
    __syncthreads();
    const int Lr = 2 * e.Kr - 2;
    edge_fix(G, S::GC, 1, r0, S::GR, S::GC, Wc, S::sw, 1, r0 - R, e.E, e.E + (e.Kr - 1) * Lr, e.Kr, H);
  }
  copy_wait_group<0>();
  __syncthreads();

  auto in = [&](int a) {
    const float* b = In + a * S::nI;
    return [=](int r, int c) { return b[(r - r0 + 1) * S::sI + (c - cs)]; };
  };
  const auto X = in(0), A = in(3);
  const MaskedDual<decltype(in(1)), decltype(in(2))> zd{in(1), in(2), H, W};
  auto grad = [=](int r, int c) { return G[(r - r0) * S::GC + (c - c0)] - 2.f * A(r, c); };
  staged_stencil<S::TR, S::TC>(Wn, r0, c0, H, W, p, X, zd, grad, [&](int r, int c, const PdsOut& o) {
    const size_t k = (size_t)r * W + c;
    xo[k] = o.xn;
    zo[k] = o.z0n;
    zo[HW + k] = o.z1n;
  });
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
  // at most the wrapper's (H / 32) x (W / 32) blocks of partials
  using S = Mega2Tile<R>;
  const size_t bytes = S::bytes;
  cudaError_t err = allow_smem(tv_mega2_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + S::TC - 1) / S::TC, (H + S::TR - 1) / S::TR);
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
  // at most the wrapper's (hloc / 32) x (W / 32) blocks of partials
  using S = Mega2ShardSmem<R>;
  const size_t bytes = S::bytes;
  cudaError_t err = allow_smem(tv_mega2_shard_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + S::TC - 1) / S::TC, (hloc + S::TR - 1) / S::TR);
  tv_mega2_shard_kernel<R><<<grid, kThreads, bytes, s>>>(
      x[0], x[1], x[2], z0[0], z0[1], z0[2], z1[0], z1[1], z1[2], atb[0], atb[1], atb[2], xo, z0o,
      z1o, partials, row0, hloc, Rh, H, W, tp, e, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

// K10's segment height: a multiple of the step of at least 32 rows (so the
// grid has no more blocks than the wrappers' partials of 32 x 32 tiles),
// cut so that the strips x segments fill two blocks an SM about once.
inline int mega3_segment(int H, int strips) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int nseg = std::max(1, (2 * sms + strips / 2) / strips);
  const int hs = (H + nseg - 1) / nseg;
  return std::max(2 * kMega3Step, (hs + kMega3Step - 1) / kMega3Step * kMega3Step);
}

template <int R>
int launch_mega3(const float* x, const float* z0, const float* z1, const float* atb, float* xo,
                 float* z0o, float* z1o, float* partials, float* stats, int H, int W,
                 const R1Taps& tp, const R1Edges& e, const PdsParams& p, cudaStream_t s) {
  const size_t bytes = Mega3Geom<R>::floats * sizeof(float);
  cudaError_t err = allow_smem(tv_mega3_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W + kStrip - 1) / kStrip, Hs = mega3_segment(H, strips);
  dim3 grid(strips, (H + Hs - 1) / Hs);
  tv_mega3_kernel<R><<<grid, kMega3Threads, bytes, s>>>(x, z0, z1, atb, xo, z0o, z1o, partials, H, W, Hs,
                                                    tp, e, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, stats);
  return (int)cudaGetLastError();
}

template <int R>
int launch_mega(const float* x, const float* z, const float* w, const float* atb, float* xo,
                float* zo, int H, int W, const R1Taps& tp, const R1Edges& e, const PdsParams& p,
                cudaStream_t s) {
  using S = MegaTile<R>;
  const size_t bytes = S::bytes;
  cudaError_t err = allow_smem(tv_mega_kernel<R>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + S::TC - 1) / S::TC, (H + S::TR - 1) / S::TR);
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
