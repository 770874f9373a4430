// Separable 'same' convolution passes over shared-memory tiles, and the
// exact Gram A^H A built on them.
//
// Shared by the convolution sweep (K1, conv2d.cu), the fused Gram (K2 and
// K18, conv2d.cu), the fused TV steps (K4, K7, K15, K17, tvr.cu), the LASSO
// step (K8, fista.cu) and the Langevin step (K9, langevin.cu).  The
// convention is the package's 'same' convolution with zero boundary:
//
//     y[p] = sum_j h[j] x[p + o - j],   o = K // 2 (forward)
//
// and the adjoint is the same pass with flipped taps at o' = K - 1 - o.
// Taps are f32 and every product is an f32 FMA: the TPU kernels' bf16x3
// split-dot machinery has no counterpart here.
//
// What bounds the Gram on this card, and what the design does about it.  The
// Gram of a 32 x 32 tile (33 x 33 for the TV steps, whose stencil reads one
// row and column more) runs four passes of K taps a rank term over the tile
// grown by the forward and adjoint reach: for K = 15, about 116k FMAs a tile
// and rank term, which at 4096^2 is about 1.9 G FMAs, 0.06 ms at an H100
// SXM's float32 rate (67 TFLOP/s at its 700 W limit).  A pass that reads its
// tap and its datum from shared memory for every FMA is bound by
// shared-memory loads instead (two a FMA), several times that.  So each pass
// is register-blocked: a thread computes kNW consecutive outputs along the
// pass axis from a window of kNW + K - 1 values in registers, each read once
// from shared memory (about 0.18 loads a FMA for K = 15), and the taps live
// in the kernel's parameter space (SepTaps, passed by value), indexed only
// with compile-time offsets inside fully unrolled loops, so that each FFMA
// takes its tap from the constant bank through a uniform register: no
// thread's register holds a tap.  K, the padded tap count of both axes (7, 15
// or 31; taps beyond the PSF's are 0 and add exact zeros after the PSF's own
// taps, in the same order), is a template parameter of every caller.  The
// rank loop is unrolled too (the taps of term k sit at a compile-time
// offset).  Along the rows (R(u)) consecutive threads take consecutive
// columns; along the columns (C(v)) consecutive threads take consecutive
// rows, with odd row strides, so that both walks are free of bank conflicts.
// Each output is owned by one thread in every rank term, so the terms
// accumulate into the output with no barrier between them; the row-pass
// scratch is double buffered, so a rank term costs one barrier.  The 'same'
// crop of t = A x (and K7's data mask) is applied as the last term stores t.
// The window x is copied in with cp.async, so a thread keeps all its copies
// in flight and no register holds them.  What is left is the callers'
// device-memory streams, the stencil, and the tile's halo.
#pragma once

#include <cuda_runtime.h>

namespace pct {

constexpr int kMaxTaps = 31;  // per axis: reach <= 15 on either side
constexpr int kMaxRank = 4;
constexpr int kTile = 32;     // output tile edge (rows and columns)
constexpr int kThreads = 256;
constexpr int kNW = 8;        // outputs a thread computes per pass item
static_assert(kTile >= kNW, "a pass walks at least kNW outputs");

// The blocks an SM should hold of a Gram kernel (its __launch_bounds__): at
// K <= 15 shared memory holds five blocks of a rank-1 Gram, so the kernels
// ask for five, which caps their registers at 51 a thread (uncapped they
// take 52-56, and only four blocks fit); at K = 31 three, no cap below what
// they take.  K7 asks for none: its mask read needs the registers, and
// capped it ran slower (PERF.md).
__host__ __device__ constexpr int gram_min_blocks(int K) { return K <= 15 ? 5 : 3; }

// A rectangle [r0, r0 + nr) x [c0, c0 + nc) of global image coordinates,
// held row-major with an odd row stride s >= nc in shared memory.
struct Region {
  float* p;
  int r0, c0, nr, nc, s;
};

__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

// The taps of one factor stack, padded with zeros to K a factor: term k is
// C(v[k]) R(u[k]); o* are the 'same' offsets of the PSF's own taps.
template <int K>
struct SepTaps {
  float u[kMaxRank][K];
  float v[kMaxRank][K];
  int rank, ou, ov;
};

// A forward stack and its adjoint (flipped taps, the gradient's scale in
// the adjoint row taps).
template <int K>
struct GramTaps {
  SepTaps<K> f, a;
};

// The padded tap count the kernels are instantiated for: 7, 15 or 31 (-1
// beyond kMaxTaps).
__host__ __forceinline__ int padded_taps(int Ku, int Kv) {
  const int k = Ku > Kv ? Ku : Kv;
  return k <= 7 ? 7 : k <= 15 ? 15 : k <= kMaxTaps ? 31 : -1;
}

// SepTaps from packed host taps u (rank, Ku) and v (rank, Kv), row-major.
template <int K>
__host__ SepTaps<K> sep_taps(const float* u, const float* v, int rank, int Ku, int Kv, int ou, int ov) {
  SepTaps<K> t{};
  for (int k = 0; k < rank; ++k) {
    for (int j = 0; j < Ku; ++j) t.u[k][j] = u[k * Ku + j];
    for (int j = 0; j < Kv; ++j) t.v[k][j] = v[k * Kv + j];
  }
  t.rank = rank;
  t.ou = ou;
  t.ov = ov;
  return t;
}

// GramTaps from the wrappers' packed host taps
// [uf (rank, Ku) | vf (rank, Kv) | ua (rank, Ku) | va (rank, Kv)].
template <int K>
__host__ GramTaps<K> gram_taps(const float* taps, int rank, int Ku, int Kv, int ouf, int ovf, int oua,
                               int ova) {
  const float* adj = taps + rank * (Ku + Kv);
  return GramTaps<K>{sep_taps<K>(taps, taps + rank * Ku, rank, Ku, Kv, ouf, ovf),
                     sep_taps<K>(adj, adj + rank * Ku, rank, Ku, Kv, oua, ova)};
}

// Calls CALL(K) with K the padded tap count of (Ku, Kv) as a constant.
#define PCT_DISPATCH_TAPS(Ku, Kv, CALL)           \
  switch (padded_taps(Ku, Kv)) {                  \
    case 7: return CALL(7);                       \
    case 15: return CALL(15);                     \
    case 31: return CALL(31);                     \
    default: return (int)cudaErrorInvalidValue;   \
  }

// Region `in` a pass into `out` reads with K padded taps at offsets (ou,
// ov): rows [out.r0 - (K - 1 - ou), out.r0 + out.nr - 1 + ou], likewise
// columns.  Local row i of `out` reads local rows [i, i + K) of `in`.
__device__ __forceinline__ Region source_region(const Region& out, int K, int ou, int ov, float* p) {
  const int nc = out.nc + K - 1;
  return Region{p, out.r0 - (K - 1 - ou), out.c0 - (K - 1 - ov), out.nr + K - 1, nc, odd_stride(nc)};
}

// Floats of one row-pass scratch buffer of a pass from `in` (nc_in
// columns) to an output of nr_out rows; a pass of rank > 1 takes two.
__host__ __device__ __forceinline__ int pass_tmp_floats(int nr_out, int nc_in) {
  return nr_out * odd_stride(nc_in);
}

// One float from device to shared memory by an asynchronous copy
// (cp.async, which needs no register and lets a thread keep all its copies
// in flight); with valid false it writes 0 and reads nothing from src, which
// must still point into the image.  The copies are done after copy_wait().
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
#else
  *dst = valid ? *src : 0.f;
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Zero-padded copy into a region of the rows a source holds: rows [lo, hi)
// and, within them, columns [clo, chi); row r's global column c is at
// row_at(r)[c - cshift].  A warp copies a row at a time, its lanes along
// the columns, so the row pointer is found once a row.  Each thread's
// copies are done when it returns; a barrier makes them the block's.
template <class RowAt>
__device__ __forceinline__ void load_rows(const Region& d, int lo, int hi, int clo, int chi, int cshift,
                                          RowAt row_at) {
  const int lane = threadIdx.x & 31;
  for (int rr = threadIdx.x >> 5; rr < d.nr; rr += kThreads / 32) {
    const int r = d.r0 + rr;
    float* dst = d.p + rr * d.s;
    if (r < lo || r >= hi) {
      for (int cc = lane; cc < d.nc; cc += 32) dst[cc] = 0.f;
      continue;
    }
    const float* src = row_at(r) - cshift;
    for (int cc = lane; cc < d.nc; cc += 32) {
      const int c = d.c0 + cc;
      const bool held = c >= clo && c < chi;
      copy_async(dst + cc, src + (held ? c : clo), held);
    }
  }
  copy_wait();
}

// Zero-padded copy of a global (H, W) image into a region.
__device__ __forceinline__ void load_region(const Region& d, const float* __restrict__ src, int H, int W) {
  load_rows(d, 0, H, 0, W, 0, [=](int r) { return src + (size_t)r * W; });
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
__device__ __forceinline__ void load_region(const Region& d, const Shard& src, int H, int W) {
  const int lo = max(0, src.row0 - src.R), hi = min(H, src.row0 + src.hloc + src.R);
  load_rows(d, lo, hi, 0, W, 0, [&](int r) {
    const int l = r - src.row0;
    return l < 0 ? src.top + (size_t)(l + src.R) * W
           : l < src.hloc ? src.core + (size_t)l * W
                          : src.bot + (size_t)(l - src.hloc) * W;
  });
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
__device__ __forceinline__ void load_region(const Region& d, const Shard2D& src, int H, int W) {
  const int lo = max(0, src.row0 - src.R), hi = min(H, src.row0 + src.hloc + src.R);
  const int clo = max(0, src.col0 - src.C), chi = min(W, src.col0 + src.wloc + src.C);
  const size_t ld = (size_t)(src.wloc + 2 * src.C);
  load_rows(d, lo, hi, clo, chi, src.col0 - src.C, [&](int r) {
    const int l = r - src.row0;
    return l < 0 ? src.top + (size_t)(l + src.R) * ld
           : l < src.hloc ? src.core + (size_t)l * ld
                          : src.bot + (size_t)(l - src.hloc) * ld;
  });
}

// The items (a, b), a < na fastest, of an na x nb grid, dealt to the
// block's threads in turn: one division a thread and pass, none an item.
template <class F>
__device__ __forceinline__ void for_each_item(int na, int nb, F&& f) {
  const int q = kThreads / na, rm = kThreads - q * na;
  int a = threadIdx.x % na, b = threadIdx.x / na;
  while (b < nb) {
    f(a, b);
    a += rm;
    b += q;
    if (a >= na) {
      a -= na;
      ++b;
    }
  }
}

// R(u) down the columns: out(i, c) = sum_j u[j] in(i + K - 1 - j, c) for
// i < n, c < nc, the taps summed from j = 0 up.  An item is kNW
// consecutive rows of one column, computed from a register window; the
// last item of a column is shifted back to end on row n - 1 and stores
// only the rows the item before it left (n >= kNW).
template <int K>
__device__ __forceinline__ void pass_rows(const float* in, int si, float* out, int so, int n, int nc,
                                          const float (&u)[K]) {
  for_each_item(nc, (n + kNW - 1) / kNW, [&](int c, int seg) {
    const int own = seg * kNW, i0 = min(own, n - kNW);
    const float* src = in + i0 * si + c;
    float w[kNW + K - 1];
#pragma unroll
    for (int k = 0; k < kNW + K - 1; ++k) w[k] = src[k * si];
#pragma unroll
    for (int o = 0; o < kNW; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(u[j], w[o + K - 1 - j], acc);
      if (i0 + o >= own) out[(i0 + o) * so + c] = acc;
    }
  });
}

// C(v) along the rows: store(i, c, sum_j v[j] in(i, c + K - 1 - j)) for
// i < nr, c < n; an item is kNW consecutive columns of one row, the last
// of a row shifted back as in pass_rows.
template <int K, class Store>
__device__ __forceinline__ void pass_cols(const float* in, int si, int nr, int n, const float (&v)[K],
                                          Store&& store) {
  for_each_item(nr, (n + kNW - 1) / kNW, [&](int i, int seg) {
    const int own = seg * kNW, c0 = min(own, n - kNW);
    const float* src = in + i * si + c0;
    float w[kNW + K - 1];
#pragma unroll
    for (int k = 0; k < kNW + K - 1; ++k) w[k] = src[k];
#pragma unroll
    for (int o = 0; o < kNW; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(v[j], w[o + K - 1 - j], acc);
      if (c0 + o >= own) store(i, c0 + o, acc);
    }
  });
}

struct NoCrop {
  __device__ __forceinline__ float operator()(int, int, float s) const { return s; }
};

// out = fin(sum_k C(v_k) R(u_k) in) on the region `out`, with `in` =
// source_region(out, K, t.ou, t.ov): the terms added in order k = 0, 1, ...
// and fin(r, c, sum) applied at global (r, c) as the last term stores.
// tmp0 and, for rank > 1, tmp1 hold pass_tmp_floats(out.nr, in.nc) floats
// each.  `in` must be ready; ends with a block barrier, so `out` is ready
// for every thread.
template <int K, class Fin>
__device__ __forceinline__ void sep_same_pass(const Region& in, const Region& out, float* tmp0, float* tmp1,
                                              const SepTaps<K>& t, Fin fin) {
#pragma unroll
  for (int k = 0; k < kMaxRank; ++k) {
    if (k < t.rank) {
      // term k - 1 read the other buffer, and every thread passed the
      // barrier after term k - 1's row pass before it got here
      float* tmp = (k & 1) ? tmp1 : tmp0;
      pass_rows<K>(in.p, in.s, tmp, in.s, out.nr, in.nc, t.u[k]);
      __syncthreads();
      const bool last = k + 1 == t.rank;
      pass_cols<K>(tmp, in.s, out.nr, out.nc, t.v[k], [&](int i, int c, float acc) {
        float* q = out.p + i * out.s + c;
        const float s = k == 0 ? acc : *q + acc;
        *q = last ? fin(out.r0 + i, out.c0 + c, s) : s;
      });
    }
  }
  __syncthreads();
}

// Shared-memory floats gram_into needs besides G itself, for an output
// region of nr x nc, padded tap count K and `rank` terms.
__host__ __device__ __forceinline__ int gram_scratch_floats(int nr, int nc, int K, int rank) {
  const int tr = nr + K - 1, tc = nc + K - 1;  // t = A x
  const int xr = tr + K - 1, xc = tc + K - 1;  // x
  const int ta = pass_tmp_floats(tr, xc), tb = pass_tmp_floats(nr, tc);
  return tr * odd_stride(tc) + xr * odd_stride(xc) + (rank > 1 ? 2 : 1) * (ta > tb ? ta : tb);
}

// G.p = (A^H A x) on region G: the forward pass t = A x on G grown by the
// adjoint reach, t zeroed outside the image (the 'same' crop: t = A x
// exists only on [0, H) x [0, W)), then the adjoint pass.  t never leaves
// shared memory.  With Masked, t is multiplied by the (H, W) data mask m
// after the crop, for the Gram A^H diag(m) A.  x is an (H, W) image in
// device memory, a Shard or a Shard2D.  Ends with a block barrier.
template <int K, bool Masked = false, class Src>
__device__ __forceinline__ void gram_into(const Src& x, int H, int W, const GramTaps<K>& g, const Region& G,
                                          float* scratch, const float* __restrict__ m = nullptr) {
  const Region T = source_region(G, K, g.a.ou, g.a.ov, scratch);
  const Region X = source_region(T, K, g.f.ou, g.f.ov, T.p + T.nr * T.s);
  float* tmp0 = X.p + X.nr * X.s;
  const int ta = pass_tmp_floats(T.nr, X.nc), tb = pass_tmp_floats(G.nr, T.nc);
  float* tmp1 = tmp0 + (ta > tb ? ta : tb);
  load_region(X, x, H, W);
  __syncthreads();
  sep_same_pass<K>(X, T, tmp0, tmp1, g.f, [=](int r, int c, float s) {
    if (r < 0 || r >= H || c < 0 || c >= W) return 0.f;
    return Masked ? s * __ldg(m + (size_t)r * W + c) : s;
  });
  sep_same_pass<K>(T, G, tmp0, tmp1, g.a, NoCrop{});
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <class Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace pct
