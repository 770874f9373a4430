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
// block owns a strip of kStrip = 63 output columns (the last shifted back
// to end on the image's edge) and a segment of rows (a multiple of the
// step, cut so that the grid fills the SMs, one block each, about once: 66
// strips x 2 segments at 4096^2, 33 x 4 at 2048^2), and walks down it in
// steps of S = 16 rows.  Each iteration's Gram is a row pass (H: the
// column taps along a row) into a ring, then a column pass (V) down the
// ring, K11's order.  Step k, g = g0 + k S, h = g - S:
//   stage 1: H1 on x rows [g + R, g + S + R) into the Cx ring; V1, Cx into
//      G1 on rows [g, g + S), each item going on to x_t1 there; U1, the
//      update on rows [g - 1, g + S - 1) into a ring of x1 rows (0 outside
//      the image: the zero boundary of the second Gram) and, on the strip
//      grown by one column, rings of its duals; all on the strip grown by
//      A = max(R, 1) columns each side (stage 2's Gram reads x1 R out);
//   stage 2: the same on x1 for rows [h, h + S), then iteration 2 on the
//      block's own pixels of rows [h - 1, h + S - 1), with the partial sums.
// What bounds it.  A step of a 63-column strip is ~11.5k warp instructions
// (two Grams of 31 taps a direction on 94 and 64 columns, 4 FFMA a
// dispatch slot; two x_t passes and two updates), ~3k cycles of the SM's
// four schedulers; its 7 streams take 0.14 ms at 4096^2.  A walker of one
// stage at a time took 1.31 ms on an H100: one block of 8 warps ran the
// two stages' seven phases in turn, each closed by a block barrier, so the
// phases added up (copies 0.26 ms, band passes 0.40, stencils 0.38); its
// edge corrections ran a dependent loop of __ldg a pixel, and its code
// outgrew the instruction cache.  Now a block of 512 threads, one an SM,
// is two groups of 8 warps, one a stage, side by side: while stage 1 makes
// step k + 1, stage 2 makes step k and brings in stage 1's rows of step k
// + 2 (an mbarrier a buffer tells stage 1 they are in): a row inside the
// image on a 16-byte address as one bulk copy by the copy engine, any
// other by 16- or 4-byte cp.async, which stall the warps that start them
// while every SM loads at once.  Each group closes its phases with its own
// named barrier (bar.sync id, 256); stage 1 hands stage 2 each step's x1
// and dual rows (bar.arrive on a "full" barrier, which stage 2 waits on),
// and stage 2 hands back the ring rows it is done with ("empty"), so stage
// 1 runs at most one step ahead (the x1 and dual rings hold 64 rows).  The
// H passes take a row and 9 or 11 outputs an item from a register window
// (a warp: 8 rows x 4 items on rows of 4 x odd floats, or 16 x 2 on 2 x
// odd: no bank conflicts); the V passes a column and 8 rows, their window
// of 8 + 2R rows read with no index arithmetic (windows start on ring
// slots 8 m, and the first 2R slots of Cx and C1 are kept again past slot
// 63); the stencils run on 2-D thread maps, a column and 8 (4) rows a
// thread, every input read into registers before any store.  The edge
// corrections read E from shared memory, spread over the threads (columns,
// after the H pass) or in the V item that owns the row.  Rows and columns
// outside the image are loaded as 0, as are z0's last row and z1's last
// column (the dual's invariant), so the stencils test no mask but the last
// row and column's gradient.  The segment's first two steps run stage 1
// alone (the fill); only the strip's sides (A columns of stage 1, A + R of
// x) and the segment's ends are computed twice.  Cx and C1 keep the rows
// [0, L) and [H - L, H) the edge corrections read: stage 1's first step
// starts on a multiple of S, 16 rows above stage 2's (itself the segment's
// first row, or earlier where the segment ends less than R rows below it),
// and rows past the image's last are written as 0 in order.  At R = 15:
// 223 KB of shared memory, one block of 512 threads an SM.  On an H100 at
// 4096^2 a launch takes 0.95 ms, one wave of 132 blocks whose length the 4
// blocks of the two edge strips set (their column corrections: an inner
// strip's block ends ~25% sooner); within a step the two groups share the
// SM's dispatch slots, and starting the row copies still holds stage 2 for
// about a third of its cycles.
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
constexpr int kStrip = 63;          // K10: output columns of a block's strip
constexpr int kMega3Step = 16;      // K10: rows a step of the walk
constexpr int kMega3Group = 256;    // K10: threads of each of its two groups
constexpr int kMega3Threads = 2 * kMega3Group;

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

__host__ __device__ constexpr int m3_round4(int n) { return (n + 3) / 4 * 4; }
// Row strides: 2 x odd floats, at least n (an H pass warp of 16 rows x 2
// items of an odd number of columns then meets 32 distinct banks), or 4 x
// odd (8 rows x 4 items, on 16-byte rows).
__host__ __device__ constexpr int m3_stride2(int n) { return (n + 1) / 4 * 4 + 2; }
__host__ __device__ constexpr int m3_stride4(int n) { return ((n + 3) / 4 | 1) * 4; }

// The pipelined strip walker's geometry for padded reach R (the design is
// in the comment at the top of this file).  Rows are global; each ring or
// buffer starts on the image column named beside it, those loaded from
// device memory on a multiple of 4 at or left of it (16-byte copies).
template <int R>
struct Mega3Geom {
  static constexpr int S = kMega3Step, CW = kStrip, NT = kMega3Group;
  static constexpr int A = R > 1 ? R : 1;    // stage 1's columns beyond the strip, each side
  static constexpr int N1 = CW + 2 * A + 1;  // Cx, x_t1, x1: from c0 - A
  static constexpr int NX = N1 + 2 * R;      // x: from c0 - A - R
  static constexpr int NI = N1 + 1;          // stage 1's z0, z1, atb: from c0 - A - 1
  static constexpr int NZ = CW + 2;          // x1's duals: from c0 - 1
  static constexpr int N2 = CW + 1;          // C1, x_t2, stage 2's atb: from c0
  static constexpr int HR = S / 2;           // rows of a V pass or U1 item
  // H passes: NW outputs an item, NS items a row, RPW rows a warp
  static constexpr int NW1 = 9, NS1 = ((N1 + NW1 - 1) / NW1 + 3) / 4 * 4, RPW1 = 8;
  static constexpr int NW2 = 11, NS2 = ((N2 + NW2 - 1) / NW2 + 1) / 2 * 2, RPW2 = 16;
  static constexpr int KX = (NX + 6) / 4, KI = (NI + 6) / 4, KA = (N2 + 6) / 4;  // 16-byte chunks a row
  // rings of NR rows (row q at slot (q - q0) & (NR - 1)); Cx and C1 keep
  // their first 2R slots again past the last, so that a V pass window (HR +
  // 2R rows from a slot 8 m) is contiguous; the x_t rings hold NT1 rows
  static constexpr int NR = 64, NM = NR + 2 * R, NT1 = 32;
  static constexpr int sX = m3_stride4(4 * KX), sC = m3_stride2(N1), s1 = m3_stride2(N1), sC1 = m3_stride2(N2);
  static constexpr int sI = 4 * KI, sA = 4 * KA, nI = (S + 1) * sI, nA2 = S * sA;
  static constexpr int nE = 4 * kMaxReach * 2 * kMaxReach;  // the edge corrections, at most
  // [x ring | Cx ring | z0, z1, atb of stage 1 (rows [g - 1, g + S)), two
  // buffers | x_t1 ring | x1 ring | z0_1, z1_1 rings | C1 ring | x_t2 ring |
  // stage 2's atb (rows [h, h + S)), two buffers | edge corrections | the
  // mbarriers of stage 1's inputs]
  static constexpr int oCx = NR * sX, oI = m3_round4(oCx + NM * sC), oT1 = oI + 6 * nI, oX1 = oT1 + NT1 * N1;
  static constexpr int oZ0 = oX1 + NR * s1, oZ1 = oZ0 + NR * NZ, oC1 = oZ1 + NR * NZ;
  static constexpr int oT2 = oC1 + NM * sC1, oA2 = m3_round4(oT2 + NT1 * N2), oE = oA2 + 2 * nA2;
  static constexpr int oMB = m3_round4(oE + nE), floats = oMB + 4;  // + two mbarriers
  static_assert(S == 16 && R + 1 <= S && 2 * N1 <= NT && 2 * NZ <= NT && 4 * N2 == NT,
                "the thread maps: two V or U1 items a column, four U2 items");
  static_assert(NS1 * NW1 + 2 * R + 3 <= sX + 4 * KX && NS2 * NW2 + 2 * R <= s1 + N1, "H pass overruns stay in the ring");
  static_assert(floats * sizeof(float) + 16 * 6 * sizeof(float) <= 227 * 1024, "one block an SM");
};

// K10's named barriers: each group's own, and the hand-offs between them
// (two of each kind, taken by even and odd steps in turn).
enum : int { kBarG1 = 1, kBarG2 = 2, kBarFull = 3, kBarEmpty = 5 };

template <int N>
__device__ __forceinline__ void m3_sync(int id) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
#endif
}

template <int N>
__device__ __forceinline__ void m3_arrive(int id) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
#endif
}

// An mbarrier in shared memory: set to expect `count` arrivals a phase; an
// arrival once this thread's earlier cp.async copies have landed (the
// thread goes on at once); a wait until the phase of the given parity is
// done.
__device__ __forceinline__ void m3_mbar_init(uint64_t* mb, int count) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"((unsigned)__cvta_generic_to_shared(mb)), "r"(count)
               : "memory");
#endif
}

__device__ __forceinline__ void m3_mbar_copies(uint64_t* mb) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"((unsigned)__cvta_generic_to_shared(mb))
               : "memory");
#endif
}

__device__ __forceinline__ void m3_mbar_wait(uint64_t* mb, int parity) {
#ifdef __CUDA_ARCH__
  unsigned done = 0;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"((unsigned)__cvta_generic_to_shared(mb)), "r"(parity)
                 : "memory");
  } while (!done);
#endif
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory by the copy engine, its bytes
// counted on the mbarrier mb (expected first, so that the phase cannot end
// before they land); the thread goes on at once.
__device__ __forceinline__ void m3_bulk(float* dst, const float* src, int bytes, uint64_t* mb) {
#ifdef __CUDA_ARCH__
  const unsigned b = (unsigned)__cvta_generic_to_shared(mb);
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes), "r"(b)
               : "memory");
#else
  std::memcpy(dst, src, bytes);
#endif
}

// Orders this thread's earlier writes to shared memory before later bulk
// copies into the same rows (the copy engine is another proxy).
__device__ __forceinline__ void m3_fence_proxy() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// Rows [qa, qb) of an (H, W) image, nk 16-byte chunks from column cs (a
// multiple of 4), to dst(q) by one group's cp.async copies, a warp a row:
// rows outside [0, hlim) and columns outside [0, wlim) come in as 0 (z0's
// last row and z1's last column are read as 0: the dual's invariant).  A
// chunk inside [0, wlim) on a 16-byte address is one copy, any other four.
// Done after copy_wait_group.  Given an mbarrier mb, a row wholly inside
// the image on a 16-byte address is instead one bulk copy by its warp's
// first thread, done when mb's phase ends.
template <class Dst>
__device__ __forceinline__ void m3_load(Dst dst, const float* __restrict__ src, int W, int hlim, int wlim, int qa,
                                        int qb, int cs, int nk, int gtid, uint64_t* mb = nullptr) {
  const int lane = gtid & 31;
  for (int q = qa + (gtid >> 5); q < qb; q += kMega3Group / 32) {
    float* d = dst(q);
    const bool rin = q >= 0 && q < hlim;
    const float* row = src + (size_t)(rin ? q : 0) * W;
    if (mb && rin && cs >= 0 && cs + 4 * nk <= wlim && (reinterpret_cast<uintptr_t>(row + cs) & 15) == 0) {
      if (lane == 0) m3_bulk(d, row + cs, 16 * nk, mb);
      continue;
    }
    for (int k = lane; k < nk; k += 32) {
      const int c = cs + 4 * k;
      if (rin && c >= 0 && c + 4 <= wlim && (reinterpret_cast<uintptr_t>(row + c) & 15) == 0) {
        copy_async16(d + 4 * k, row + c);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = rin && c + u >= 0 && c + u < wlim;
          copy_async(d + 4 * k + u, row + (in ? c + u : 0), in);
        }
      }
    }
  }
}

// sum_l e[l] v[l * sv] for l < L (L even), in two halves; one copy of
// the code for every row edge correction (they run in a V item on the
// image's first and last rows only).
__device__ __noinline__ float m3_dot(const float* e, const float* v, int sv, int L) {
  float a = 0.f, b = 0.f;
  for (int l = 0; l < L; l += 2) {
    a = fmaf(e[l], v[l * sv], a);
    b = fmaf(e[l + 1], v[(l + 1) * sv], b);
  }
  return a + b;
}

// H pass: out(q, j) = sum_t ac[t] in(q, j + t) for the nr rows from qa and
// j < nout.  An item is a row and NW outputs from a register window; a warp
// takes RPW rows and 32 / RPW items of each.  in(q): the row's pointer;
// out(q, j, v) stores output j.
template <int R, int NW, int NS, int RPW, class In, class Out>
__device__ __forceinline__ void m3_hpass(In in, Out out, int qa, int nr, int nout, const R1Taps& tp, int gtid) {
  constexpr int SPW = 32 / RPW, WPB = NS / SPW;  // items of a row a warp; warps a block of RPW rows
  static_assert(NS % SPW == 0, "whole warps");
  for (int it = gtid; it < (nr + RPW - 1) / RPW * WPB * 32; it += kMega3Group) {
    const int wi = it >> 5, lane = it & 31, rb = wi / WPB;
    const int i = rb * RPW + lane % RPW, j0 = ((wi - rb * WPB) * SPW + lane / RPW) * NW;
    if (i >= nr) continue;
    const int q = qa + i;
    const float* src = in(q) + j0;
    float win[NW + 2 * R];
#pragma unroll
    for (int t = 0; t < NW + 2 * R; ++t) win[t] = src[t];
#pragma unroll
    for (int o = 0; o < NW; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t <= 2 * R; ++t) acc = fmaf(tp.ac[t], win[o + t], acc);
      if (j0 + o < nout) out(q, j0 + o, acc);
    }
  }
}

// sum_l e[l] v[l] for l < L (L even), in four partial sums: the column
// corrections' dot, inline (one item a thread, run after the H pass).
__device__ __forceinline__ float m3_dot_row(const float* e, const float* v, int L) {
  float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
  int l = 0;
  for (; l + 4 <= L; l += 4) {
    a = fmaf(e[l], v[l], a);
    b = fmaf(e[l + 1], v[l + 1], b);
    c = fmaf(e[l + 2], v[l + 2], c);
    d = fmaf(e[l + 3], v[l + 3], d);
  }
  if (l < L) {
    a = fmaf(e[l], v[l], a);
    b = fmaf(e[l + 1], v[l + 1], b);
  }
  return (a + c) + (b + d);
}

// The column edge corrections (edge_fix's columns, top then bottom) of an H
// pass's nr rows from qa: output j (image column oc0 + j, j < nout) gets
// sum_l Et[c][l] x(l) for c < Kc - 1 and sum_l Eb[c - W + Kc - 1][l] x(W - L
// + l) for c >= W - Kc + 1, x read through in(q) (image column ic0 first).
// An item is an output; fix(q, j, v) adds v.  Es: [Etc | Ebc].
template <class In, class Fix>
__device__ __forceinline__ void m3_col_fix(In in, Fix fix, int qa, int nr, int nout, int oc0, int ic0, int W,
                                           const float* Es, int K, int gtid) {
  const int k1 = K - 1, L = 2 * K - 2;
  const int la = max(0, -oc0), lb = min(nout, k1 - oc0), ra = max(lb, max(0, W - k1 - oc0)), rb = min(nout, W - oc0);
  const int nl = max(0, lb - la), ne = nl + max(0, rb - ra);
  for (int it = gtid; it < nr * ne; it += kMega3Group) {
    const int i = it / ne, e = it - i * ne, j = e < nl ? la + e : ra + e - nl, c = oc0 + j, q = qa + i;
    const float* x = in(q) - ic0;  // image column 0
    float v = 0.f;
    bool top = c < k1;
    if (top) v = m3_dot_row(Es + c * L, x, L);
    if (c >= W - k1) {
      const float b = m3_dot_row(Es + (k1 + c - (W - k1)) * L, x + W - L, L);
      fix(q, j, top ? v : 0.f);
      v = b;
    }
    fix(q, j, v);
  }
}

// V pass item: g[o] = sum_t ar[t] C(q + o + t - R) for o < HR, from the
// contiguous window src (row q - R of a ring column, stride s), plus the
// row edge corrections (edge_fix's rows, top then bottom), which read the
// ring's rows [0, L) and [H - L, H) from crow(0) and crow(H - L) (stride
// ss).  Es: [Etr | Ebr].
template <int R, int HR, class CRow>
__device__ __forceinline__ void m3_vpass(float (&g)[HR], const float* src, int s, int q, int H, const R1Taps& tp,
                                         const float* Es, int K, CRow crow, int ss) {
  float win[HR + 2 * R];
#pragma unroll
  for (int t = 0; t < HR + 2 * R; ++t) win[t] = src[t * s];
#pragma unroll
  for (int o = 0; o < HR; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t <= 2 * R; ++t) acc = fmaf(tp.ar[t], win[o + t], acc);
    g[o] = acc;
  }
  if (meets_edges(q, HR, K, H)) {
    const int k1 = K - 1, L = 2 * K - 2;
#pragma unroll
    for (int o = 0; o < HR; ++o) {
      const int r = q + o;
      if (r >= 0 && r < k1) g[o] += m3_dot(Es + r * L, crow(0), ss, L);
      if (r >= H - k1 && r < H) g[o] += m3_dot(Es + (k1 + r - (H - k1)) * L, crow(H - L), ss, L);
    }
  }
}

// x_t = P(x - tau g - tau div z) (MaskedDual::x_t's arithmetic) from the
// Gram's g (2x folded in), atb, x and the dual's four values.
__device__ __forceinline__ float m3_xt(float gv, float a, float xv, float z0u, float z0c, float z1l, float z1c,
                                       const PdsParams& p) {
  const float div = (z0u - z0c) + (z1l - z1c);
  const float v = xv - p.tau * (gv - 2.f * a) - p.tau * div;
  return p.nonneg ? fmaxf(v, 0.f) : v;
}

// pds_update's arithmetic on unmasked duals: du_r only when down (r < H -
// 1), du_c only when right (c < W - 1).
__device__ __forceinline__ PdsOut m3_update(const PdsParams& p, bool down, bool right, float x0, float xt, float xd,
                                            float xtd, float xr, float xtr, float z0, float z1) {
  const float u = 2.f * xt - x0;
  const float du_r = down ? (2.f * xtd - xd) - u : 0.f;
  const float du_c = right ? (2.f * xtr - xr) - u : 0.f;
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
  return PdsOut{p.rho * xt + keep * x0, p.rho * z0t + keep * z0, p.rho * z1t + keep * z1, x0, z0, z1};
}

template <int R>
__global__ void __launch_bounds__(kMega3Threads, 1)
tv_mega3_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                const float* __restrict__ z1, const float* __restrict__ atb,
                float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                float* __restrict__ partials, int H, int W, int Hs, R1Taps tp, R1Edges e, PdsParams p) {
  using G = Mega3Geom<R>;
  constexpr int S = G::S, CW = G::CW, A = G::A, NT = G::NT, HR = G::HR, N1 = G::N1, N2 = G::N2, NZ = G::NZ;
  constexpr int M = G::NR - 1, MT = G::NT1 - 1, K2 = 2;  // K2: stage 1's steps before stage 2's first
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c0 = span_origin(blockIdx.x, CW, W), cn = blockIdx.x * CW, ce = min(cn + CW, W);  // own [cn, ce)
  const int r0 = blockIdx.y * Hs, r1 = min(r0 + Hs, H);                                          // own [r0, r1)
  // stage 2's first step: rows [h0, h0 + S), the segment's first row, or
  // earlier where the segment ends less than R rows below it (so that the
  // walk makes the rows [H - L, H) the last rows' edge corrections read);
  // stage 1's first, S rows above (h0 and g0 are multiples of S: some step
  // starts on row 0, and holds the rows [0, L) the top corrections read)
  const int h0 = min(r0, (H - R) & ~(S - 1)), g0 = h0 - S;
  const int nsteps = K2 + (r1 - h0 + S) / S;
  const int gtid = threadIdx.x & (NT - 1);
  // the edge corrections [Etr | Ebr | Etc | Ebc] into shared memory
  float* Es = smem + G::oE;
  const float* Esc = Es + 2 * (e.Kr - 1) * (2 * e.Kr - 2);
  for (int i = threadIdx.x; i < 2 * (e.Kr - 1) * (2 * e.Kr - 2) + 2 * (e.Kc - 1) * (2 * e.Kc - 2); i += kMega3Threads)
    Es[i] = e.E[i];
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem + G::oMB);
  if (threadIdx.x == 0) {
    m3_mbar_init(mb, NT);
    m3_mbar_init(mb + 1, NT);
  }
  __syncthreads();
  // the rings stage 1 hands stage 2 (row q at slot (q - g0) & M)
  float* X1 = smem + G::oX1;
  float* Z0 = smem + G::oZ0;
  float* Z1 = smem + G::oZ1;
  Stats6 st;
  st.zero();

  // stage 1's inputs of step k: x rows into the x ring (the first step's
  // whole window), z0, z1 and atb rows [g - 1, g + S) into In buffer k &
  // 1.  Stage 1 loads its first K2 + 2 steps' itself, one step ahead;
  // stage 2 the rest, two steps ahead of stage 1, each made known by the
  // mbarrier of its buffer.
  float* Xr = smem;           // x: row q at slot (q - g0) & M, column xa + j
  float* In0 = smem + G::oI;  // z0, z1, atb of step k: buffer k & 1, row q - g + 1, column za + j
  const int xa = (c0 - A - R) & ~3, za = (c0 - A - 1) & ~3, ix = c0 - A - xa, iz = c0 - A - za;
  auto load_step = [&](int k, uint64_t* bar) {
    const int g = g0 + k * S;
    m3_load([&](int q) { return Xr + ((q - g0) & M) * G::sX; }, x, W, H, W, k == 0 ? g - R : g + R, g + S + R, xa,
            G::KX, gtid, bar);
    float* b = In0 + (k & 1) * 3 * G::nI;
    auto rows = [&](float* a) { return [=](int q) { return a + (q - g + 1) * G::sI; }; };
    m3_load(rows(b), z0, W, H - 1, W, g - 1, g + S, za, G::KI, gtid, bar);
    m3_load(rows(b + G::nI), z1, W, H, W - 1, g - 1, g + S, za, G::KI, gtid, bar);
    m3_load(rows(b + 2 * G::nI), atb, W, H, W, g - 1, g + S, za, G::KI, gtid, bar);
  };

  if (threadIdx.x < NT) {
    // stage 1, step k (g = g0 + k S): H1, the row pass of x rows [g + R, g +
    // S + R) into Cx; V1, the column pass of Cx into G1 on rows [g, g + S),
    // each item going on to x_t1 there; U1, iteration 1's update on rows [g
    // - 1, g + S - 1) into x1 (0 outside the image) and the duals
    float* Cx = smem + G::oCx;  // row q at slot (q - g0 + R) & M (windows from slots 8 m), column c0 - A + j
    float* T1 = smem + G::oT1;  // x_t1: row q at slot (q - g0) & MT
    const bool fix1 = meets_edges(c0 - A, N1, e.Kc, W);
    auto xrow = [&](int q) { return Xr + ((q - g0) & M) * G::sX + (ix - R); };  // image column c0 - A - R
    load_step(0, nullptr);
    copy_commit();
    for (int k = 0; k < nsteps; ++k) {
      const int g = g0 + k * S;
      const float* In = In0 + (k & 1) * 3 * G::nI;
      if (k < K2 + 2) {
        copy_wait_group<0>();
        m3_fence_proxy();  // these rows are later written by bulk copies
      } else {
        m3_mbar_wait(mb + (k & 1), ((k - K2 - 2) >> 1) & 1);
      }
      m3_sync<NT>(kBarG1);  // step k's inputs are in; step k - 1 is done with every buffer
      if (k + 1 < nsteps && k + 1 < K2 + 2) load_step(k + 1, nullptr);
      copy_commit();
      {
        const int qa = k == 0 ? g - R : g + R, nr = k == 0 ? S + 2 * R : S;
        auto cx = [&](int q, int j) -> float& { return Cx[((q - g0 + R) & M) * G::sC + j]; };
        auto put = [&](int q, int j, float v) {
          const int t = (q - g0 + R) & M;
          Cx[t * G::sC + j] = v;
          if (t < 2 * R) Cx[(t + G::NR) * G::sC + j] = v;
        };
        m3_hpass<R, G::NW1, G::NS1, G::RPW1>(xrow, put, qa, nr, N1, tp, gtid);
        if (fix1) {
          m3_sync<NT>(kBarG1);
          m3_col_fix(xrow, [&](int q, int j, float v) { put(q, j, cx(q, j) + v); }, qa, nr, N1, c0 - A, c0 - A - R, W,
                     Esc, e.Kc, gtid);
        }
      }
      m3_sync<NT>(kBarG1);
      if (gtid < 2 * N1) {
        const int hf = gtid >= N1, j = gtid - hf * N1, q = g + hf * HR;
        float gv[HR];
        const float* cw = Cx + ((q - g0) & M) * G::sC + j;  // row q - R: a slot 8 m
        m3_vpass<R, HR>(gv, cw, G::sC, q, H, tp, Es, e.Kr,
                        [&](int r) { return Cx + ((r - g0 + R) & M) * G::sC + j; }, G::sC);
        // x_t1 on rows [q, q + HR): every input first (rows from a slot 8 m: no wrap)
        const float* xs = Xr + ((q - g0) & M) * G::sX + j + ix;
        const float* zi = In + (q - g) * G::sI + j + iz - 1;  // row q - 1 of the inputs, column c - 1
        float z0v[HR + 1], z1l[HR], z1c[HR], av[HR], xv[HR];
        z0v[0] = zi[1];
#pragma unroll
        for (int o = 0; o < HR; ++o) {
          const float* zr = zi + (o + 1) * G::sI;
          z0v[o + 1] = zr[1];
          z1l[o] = zr[G::nI];
          z1c[o] = zr[G::nI + 1];
          av[o] = zr[2 * G::nI + 1];
          xv[o] = xs[o * G::sX];
        }
        float* t = T1 + ((q - g0) & MT) * N1 + j;
#pragma unroll
        for (int o = 0; o < HR; ++o) t[o * N1] = m3_xt(gv[o], av[o], xv[o], z0v[o], z0v[o + 1], z1l[o], z1c[o], p);
      }
      m3_sync<NT>(kBarG1);
      if (k - 2 >= K2) m3_sync<2 * NT>(kBarEmpty + (k & 1));  // stage 2 is done with step k - 2's rows
      if (gtid < 2 * N1) {
        // a column and HR rows from g - 1 + HR hf: the duals' columns take the
        // whole update, the others only x1 = rho x_t + (1 - rho) x
        const bool full = gtid < 2 * NZ;
        const int t0 = full ? gtid : gtid - 2 * NZ, n = full ? NZ : N1 - NZ;
        const int hf = t0 >= n, jj = t0 - hf * n;
        const int j = full ? jj + A - 1 : (jj < A - 1 ? jj : jj + NZ), c = c0 - A + j;
        const int q = g - 1 + hf * HR;
        const bool cin = c >= 0 && c < W, right = c < W - 1;
        // row q at its own slot, rows q + 1 .. q + HR from a slot 8 m on
        const int sa = (q - g0) & M, sb = (q + 1 - g0) & M;
        const float* xa_ = Xr + sa * G::sX + j + ix;
        const float* xb_ = Xr + sb * G::sX + j + ix;
        const float* ua = T1 + ((q - g0) & MT) * N1 + j;
        const float* ub = T1 + ((q + 1 - g0) & MT) * N1 + j;
        float tv[HR + 1], xv[HR + 1];
        tv[0] = ua[0];
        xv[0] = xa_[0];
#pragma unroll
        for (int o = 0; o < HR; ++o) {
          tv[o + 1] = ub[o * N1];
          xv[o + 1] = xb_[o * G::sX];
        }
        if (full) {
          const float* zi = In + (q - g + 1) * G::sI + j + iz;  // row q of the inputs, column c
          float tr[HR], xr[HR], zz0[HR], zz1[HR];
#pragma unroll
          for (int o = 0; o < HR; ++o) {
            tr[o] = o == 0 ? ua[1] : ub[(o - 1) * N1 + 1];
            xr[o] = o == 0 ? xa_[1] : xb_[(o - 1) * G::sX + 1];
            zz0[o] = zi[o * G::sI];
            zz1[o] = zi[G::nI + o * G::sI];
          }
#pragma unroll
          for (int o = 0; o < HR; ++o) {
            const int r = q + o, s = o == 0 ? sa : sb + o - 1;
            const PdsOut u = m3_update(p, r < H - 1, right, xv[o], tv[o], xv[o + 1], tv[o + 1], xr[o], tr[o], zz0[o], zz1[o]);
            const bool in = r >= 0 && r < H && cin;
            X1[s * G::s1 + j] = in ? u.xn : 0.f;
            Z0[s * NZ + jj] = in ? u.z0n : 0.f;
            Z1[s * NZ + jj] = in ? u.z1n : 0.f;
          }
        } else {
#pragma unroll
          for (int o = 0; o < HR; ++o) {
            const int r = q + o, s = o == 0 ? sa : sb + o - 1;
            X1[s * G::s1 + j] = r >= 0 && r < H && cin ? p.rho * tv[o] + (1.f - p.rho) * xv[o] : 0.f;
          }
        }
      }
      if (k >= K2) {
        __threadfence_block();
        m3_arrive<2 * NT>(kBarFull + (k & 1));  // x1 and the duals of rows [g - 1, g + S - 1) are in
      }
    }
  } else {
    // stage 2, step k (h = g - S, one step behind stage 1): H2, the row pass
    // of x1 rows [h + R, h + S + R) into C1; V2, the column pass into G2 on
    // rows [h, h + S), each item going on to x_t2; U2, iteration 2's update
    // on the block's own pixels of rows [h - 1, h + S - 1), with the sums
    float* C1 = smem + G::oC1;   // row q at slot (q - h0 + R) & M (windows from slots 8 m), column c0 + j
    float* T2 = smem + G::oT2;   // x_t2: row q at slot (q - h0) & MT, column c0 + j
    float* A20 = smem + G::oA2;  // atb of step k: buffer k & 1, row q - h, column aa + j
    const int aa = c0 & ~3, ia = c0 - aa;
    const bool fix2 = meets_edges(c0, N2, e.Kc, W);
    auto x1row = [&](int q) { return X1 + ((q - g0) & M) * G::s1 + (A - R); };  // image column c0 - R
    auto load_atb = [&](int k) {
      const int h = g0 + k * S - S;
      float* b = A20 + (k & 1) * G::nA2;
      m3_load([&](int q) { return b + (q - h) * G::sA; }, atb, W, H, W, h, h + S, aa, G::KA, gtid);
    };
    load_atb(K2);
    copy_commit();
    for (int k = K2; k < nsteps; ++k) {
      const int h = g0 + k * S - S;
      const float* A2 = A20 + (k & 1) * G::nA2;
      copy_wait_group<0>();
      m3_fence_proxy();  // this thread's cp.async rows, before bulk copies into them
      m3_sync<2 * NT>(kBarFull + (k & 1));  // stage 1 has made step k; step k - 1 is done with every buffer
      if (k + 2 < nsteps) {
        load_step(k + 2, mb + (k & 1));  // into the In buffer stage 1 has just left
        m3_mbar_copies(mb + (k & 1));
      }
      if (k + 1 < nsteps) load_atb(k + 1);
      copy_commit();
      {
        const int qa = k == K2 ? h - R : h + R, nr = k == K2 ? S + 2 * R : S;
        auto put = [&](int q, int j, float v) {
          const int t = (q - h0 + R) & M;
          C1[t * G::sC1 + j] = v;
          if (t < 2 * R) C1[(t + G::NR) * G::sC1 + j] = v;
        };
        m3_hpass<R, G::NW2, G::NS2, G::RPW2>(x1row, put, qa, nr, N2, tp, gtid);
        if (fix2) {
          m3_sync<NT>(kBarG2);
          m3_col_fix(x1row, [&](int q, int j, float v) { put(q, j, C1[((q - h0 + R) & M) * G::sC1 + j] + v); }, qa,
                     nr, N2, c0, c0 - R, W, Esc, e.Kc, gtid);
        }
      }
      m3_sync<NT>(kBarG2);
      if (gtid < 2 * N2) {
        const int hf = gtid >= N2, j = gtid - hf * N2, q = h + hf * HR;
        float gv[HR];
        const float* cw = C1 + ((q - h0) & M) * G::sC1 + j;  // row q - R: a slot 8 m
        m3_vpass<R, HR>(gv, cw, G::sC1, q, H, tp, Es, e.Kr,
                        [&](int r) { return C1 + ((r - h0 + R) & M) * G::sC1 + j; }, G::sC1);
        // x_t2 on rows [q, q + HR): every input first (x1 and dual rows from a slot 8 m: no wrap)
        const int s = (q - g0) & M;
        const float* xs = X1 + s * G::s1 + j + A;
        const float* z0r = Z0 + s * NZ + j + 1;
        const float* z1r = Z1 + s * NZ + j;
        const float* ar = A2 + (q - h) * G::sA + j + ia;
        float z0v[HR + 1], z1l[HR], z1c[HR], av[HR], xv[HR];
        z0v[0] = Z0[((q - 1 - g0) & M) * NZ + j + 1];
#pragma unroll
        for (int o = 0; o < HR; ++o) {
          z0v[o + 1] = z0r[o * NZ];
          z1l[o] = z1r[o * NZ];
          z1c[o] = z1r[o * NZ + 1];
          av[o] = ar[o * G::sA];
          xv[o] = xs[o * G::s1];
        }
        float* t = T2 + ((q - h0) & MT) * N2 + j;
#pragma unroll
        for (int o = 0; o < HR; ++o) t[o * N2] = m3_xt(gv[o], av[o], xv[o], z0v[o], z0v[o + 1], z1l[o], z1c[o], p);
      }
      m3_sync<NT>(kBarG2);
      {
        // a column and 4 rows from h - 1 + 4 qq: every input first
        const int j = gtid & (N2 - 1), qq = gtid / N2, c = c0 + j, q = h - 1 + 4 * qq;
        const bool own = c >= cn && c < ce, right = c < W - 1;
        const int sa = (q - g0) & M, sb = (q + 1 - g0) & M;
        const float* xa_ = X1 + sa * G::s1 + j + A;
        const float* xb_ = X1 + sb * G::s1 + j + A;
        const float* ua = T2 + ((q - h0) & MT) * N2 + j;
        const float* ub = T2 + ((q + 1 - h0) & MT) * N2 + j;
        float tv[5], xv[5], tr[4], xr[4], zz0[4], zz1[4];
        tv[0] = ua[0];
        xv[0] = xa_[0];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int s = o == 0 ? sa : sb + o - 1;
          tv[o + 1] = ub[o * N2];
          xv[o + 1] = xb_[o * G::s1];
          tr[o] = o == 0 ? ua[1] : ub[(o - 1) * N2 + 1];
          xr[o] = o == 0 ? xa_[1] : xb_[(o - 1) * G::s1 + 1];
          zz0[o] = Z0[s * NZ + j + 1];
          zz1[o] = Z1[s * NZ + j + 1];
        }
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int r = q + o;
          if (own && r >= r0 && r < r1) {
            const PdsOut u = m3_update(p, r < H - 1, right, xv[o], tv[o], xv[o + 1], tv[o + 1], xr[o], tr[o], zz0[o],
                                       zz1[o]);
            const size_t i = (size_t)r * W + c;
            xo[i] = u.xn;
            z0o[i] = u.z0n;
            z1o[i] = u.z1n;
            st.add(u);  // the second iteration against the first
          }
        }
      }
      if (k + 2 < nsteps) m3_arrive<2 * NT>(kBarEmpty + (k & 1));  // done with step k's x1 and dual rows
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
// cut so that the strips x segments fill the SMs, one block each, about once.
inline int mega3_segment(int H, int strips) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int nseg = std::max(1, (sms + strips / 2) / strips);
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
