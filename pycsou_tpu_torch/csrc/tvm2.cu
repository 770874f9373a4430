// K6: two masked TV primal-dual iterations in one kernel (the data
// gradient of a diagonal Gram, g = 2 (m x - atb), formed in the kernel),
// with the stopping-metric partial sums of the second iteration only.
//
// Replaces pycsou_tpu/kernels/tv.py tv_pds_sweepm2_step
// (_tv_sweepm2_kernel).  The TPU kernel runs a two-stage software pipeline
// over an ordered grid of row tiles: stage 1 of tile i-1 and stage 2 of
// tile i-2 in one grid step, the stage-1 rows in a scratch ring.  Blocks on
// the card run in no order, so here each block does temporal blocking in
// shared memory instead.  One iteration at (r, c) reads (r +- 1, c +- 1),
// the diagonals (r + 1, c - 1) and (r - 1, c + 1) included, so the second
// iteration over a tile needs the first over the tile grown by 1, and that
// the inputs over the tile grown by 2.  The first iteration's values never
// reach device memory.
//
// Bound by device-memory traffic: 8 image streams for TWO iterations (x, m,
// atb, z0, z1 in; x'', z0'', z1'' out), half of K5's bytes an iteration.
// Its first version loaded 32 x 32 tiles a float at a time (a division by 36,
// a bounds test and an __ldg each, unaligned, all five streams before any
// arithmetic) and computed x_t three times a pixel in both iterations
// (0.3775 ms at 4096^2 against a 0.1603 ms bound on an H100 SXM at 700 W).
// Now the tiles are 32 x 64 output pixels (the last row and column tiles
// shifted back to end on the edge; pixels another tile owns are skipped),
// walked by two blocks an SM (tiles t = blockIdx.x, blockIdx.x + gridDim.x,
// ...; the partial sums carried from tile to tile, so the fold reads 264
// slots on an H100, not one a tile).  For each tile a block
//   - resolves each staged row's pointer once into a table in shared memory
//     (ImageRows: nullptr outside [0, H), read as 0) and copies x, m, atb,
//     z0 and z1 over rows [r0 - 2, r0 + 34) and columns [cs, cs + 72), cs =
//     c0 - 2 rounded down to a multiple of 4, by cp.async: 16 bytes where a
//     4-float chunk lies inside [0, W) on a 16-byte address, 4 bytes with
//     zero fill elsewhere (stage_tile; 1.27x the tile's inputs, the overlap
//     read from L2);
//   - iteration 1: x_t once a pixel on the tile grown by 1 plus one row and
//     column (35 x 67), then pds_update on the tile grown by 1 (34 x 66)
//     into shared memory; iteration 2 likewise: x_t on 33 x 65 from those
//     values, then pds_update on the tile, whose stores go out by float4
//     where the row allows, with the partial sums against iteration 1;
//   - issues the next tile's x, z0 and z1 copies once iteration 1 is done
//     with them, m and atb once iteration 2's x_t is, so that they arrive
//     while this tile's second iteration runs;
//   - on a tile clear of the image's edges (all but the outer ring) makes
//     no edge test: neither the bounds nor the dual masks (MaskedDual with
//     AtEdge false);
//   - walks rows with its warps and columns with their lanes (for_region):
//     no division in the loops over pixels.
// About 92 KB of shared memory (the staged inputs 51.8 KB, iteration 1's
// outputs 29.4, x_t 10.1, two row tables 2.9): two blocks an SM.  The
// launcher raises the kernel's shared-memory limit and reads the SM count
// once a device, not on every launch (the masked paths run near the host's
// pace).  Image borders: the stencil reads only in-image neighbours and
// masks the dual invariant (the last row of z0, the last column of z1 read
// as 0), so values outside the image are never read.
#include <algorithm>
#include <atomic>
#include <type_traits>

#include "sepconv.cuh"
#include "pds_stencil.cuh"
#include "shard_tile.cuh"

namespace pct {

// K6's geometry: a TR x TC output tile at (r0, c0); x, m, atb, z0, z1
// staged over rows [r0 - 2, r0 + TR + 2) and NK 16-byte chunks a row from
// cs; iteration 1's x_t on XR x XC and its outputs on MR x MC from (r0 - 1,
// c0 - 1), iteration 2's x_t on (MR - 1) x (MC - 1) from (r0, c0), all held
// from origin (r0 - 1, c0 - 4) with row stride sM (a multiple of 4: the
// second iteration reads 4 columns by float4).  Shared memory: two row
// tables, then [x, m, atb, z0, z1 | x', z0', z1' | x_t].
constexpr int kM2BlocksPerSM = 2;  // what shared memory holds of SweepM2Tile::bytes

struct SweepM2Tile {
  static constexpr int TR = kTile, TC = 64;
  static constexpr int NR = TR + 4, NK = TC / 4 + 2, sI = 4 * NK, nI = NR * sI;
  static constexpr int MR = TR + 2, MC = TC + 2, XR = MR + 1, XC = MC + 1;
  static constexpr int sM = 72, nM = MR * sM;
  static constexpr int ptrs = 5 * NR, ptr_bytes = 2 * ptrs * (int)sizeof(const float*);
  static constexpr int oM = 5 * nI, oT = oM + 3 * nM;
  static constexpr size_t bytes = ptr_bytes + (size_t)(oT + XR * sM) * sizeof(float);
  static_assert(ptr_bytes % 16 == 0 && ptrs <= kThreads, "one pointer a thread, 16-byte rows after");
  static_assert(XC + 3 <= sM && sM % 4 == 0 && sI >= TC + 7, "the layouts hold their regions");
  static_assert(kM2BlocksPerSM * (bytes + 1024) <= 228 * 1024, "the blocks an SM fit");
};

// f(i, j) for each (i, j) of an NR x NC region, 64 < NC <= 68: warps take
// the rows and lanes the first 64 columns; the further columns' items, in
// slots of a power of two a row, go one a thread from the last thread down
// (the warps with fewer rows).
template <int NR, int NC, class F>
__device__ __forceinline__ void for_region(F f) {
  static_assert(NC > 64 && NC <= 68, "64 columns by lanes, at most 4 more");
  constexpr int L = NC - 64 <= 1 ? 0 : NC - 64 <= 2 ? 1 : 2;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < NR; i += kThreads / 32) {
    f(i, lane);
    f(i, lane + 32);
  }
  for (int it = kThreads - 1 - (int)threadIdx.x; it < (NR << L); it += kThreads) {
    const int j = 64 + (it & ((1 << L) - 1));
    if (j < NC) f(it >> L, j);
  }
}

__device__ __forceinline__ float4 ld4(const float* s) { return *reinterpret_cast<const float4*>(s); }

__device__ __forceinline__ bool aligned16(const float* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__global__ void __launch_bounds__(kThreads, kM2BlocksPerSM)
tv_sweepm2_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                  const float* __restrict__ z1, const float* __restrict__ m,
                  const float* __restrict__ atb, float* __restrict__ xo, float* __restrict__ z0o,
                  float* __restrict__ z1o, float* __restrict__ partials, int H, int W,
                  PdsParams p) {
  using S = SweepM2Tile;
  extern __shared__ float4 smem4[];
  const float** tables = reinterpret_cast<const float**>(smem4);  // two of ptrs each
  float* In = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + S::ptr_bytes);
  float* X1 = In + S::oM;  // x', z0', z1' (iteration 1)
  float* Z01 = X1 + S::nM;
  float* Z11 = Z01 + S::nM;
  float* Xt = In + S::oT;  // x_t of the iteration running
  const int ntx = (W + S::TC - 1) / S::TC, ntiles = ntx * ((H + S::TR - 1) / S::TR);
  auto origin = [&](int t, int& r0, int& c0, int& rn, int& cn) {
    const int ty = t / ntx, tx = t - ty * ntx;
    r0 = span_origin(ty, S::TR, H), c0 = span_origin(tx, S::TC, W), rn = ty * S::TR, cn = tx * S::TC;
  };
  // image a's (x, m, atb, z0, z1) staged row r0 - 2 + i into table[a * NR + i]
  auto resolve = [&](const float** table, int r0) {
    if (threadIdx.x < S::ptrs) {
      const int a = threadIdx.x / S::NR, i = threadIdx.x - a * S::NR;
      const float* img = a == 0 ? x : a == 1 ? m : a == 2 ? atb : a == 3 ? z0 : z1;
      table[threadIdx.x] = ImageRows{img, H, W}.row(r0 - 2 + i);
    }
  };
  auto stage = [&](const float* const* table, int c0, int a0, int a1) {
    for (int a = a0; a < a1; ++a)
      stage_tile<S::NR, S::NK, kThreads>(In + a * S::nI, S::sI, table + a * S::NR, (c0 - 2) & ~3, W);
    copy_commit();
  };

  int t = blockIdx.x, r0, c0, rn, cn;
  origin(t, r0, c0, rn, cn);
  resolve(tables, r0);
  __syncthreads();
  stage(tables, c0, 0, 5);
  Stats6 st;
  st.zero();
  for (int k = 0; t < ntiles; t += gridDim.x, ++k) {
    const bool more = t + (int)gridDim.x < ntiles;
    const float** next_rows = tables + ((k + 1) & 1) * S::ptrs;
    int r0n = 0, c0n = 0, rnn = 0, cnn = 0;
    if (more) origin(t + gridDim.x, r0n, c0n, rnn, cnn);
    copy_wait_group<0>();
    __syncthreads();

    // the tile's two iterations; a tile clear of the image's edges (all but
    // the outer ring of tiles) makes no edge test
    auto tile = [&](auto at_edge) {
      constexpr bool E = decltype(at_edge)::value;
      // the staged inputs in image coordinates
      const int cs = (c0 - 2) & ~3;
      auto in = [&](int a) {
        const float* b = In + a * S::nI;
        return [=](int r, int c) { return b[(r - r0 + 2) * S::sI + (c - cs)]; };
      };
      const auto X = in(0), M = in(1), A = in(2);
      const MaskedDual<decltype(in(3)), decltype(in(4)), E> zd0{in(3), in(4), H, W};
      auto g0 = [=](int r, int c) { return masked_grad(M(r, c), X(r, c), A(r, c)); };

      // iteration 1, x_t on rows [r0 - 1, r0 + 34) x columns [c0 - 1, c0 + 66)
      for_region<S::XR, S::XC>([&](int i, int j) {
        const int r = r0 - 1 + i, c = c0 - 1 + j;
        if (E && (r < 0 || r >= H || c < 0 || c >= W)) return;
        Xt[i * S::sM + j + 3] = zd0.x_t(r, c, X(r, c), g0, p);
      });
      __syncthreads();
      if (more) resolve(next_rows, r0n);
      // iteration 1's update on rows [r0 - 1, r0 + 33) x columns [c0 - 1, c0 + 65)
      for_region<S::MR, S::MC>([&](int i, int j) {
        const int r = r0 - 1 + i, c = c0 - 1 + j;
        if (E && (r < 0 || r >= H || c < 0 || c >= W)) return;
        const int b = i * S::sM + j + 3;
        const bool down = !E || r < H - 1, right = !E || c < W - 1;
        const PdsOut o = pds_update(r, c, H, W, p, zd0, X(r, c), Xt[b], down ? X(r + 1, c) : 0.f,
                                    down ? Xt[b + S::sM] : 0.f, right ? X(r, c + 1) : 0.f, right ? Xt[b + 1] : 0.f);
        X1[b] = o.xn;
        Z01[b] = o.z0n;
        Z11[b] = o.z1n;
      });
      __syncthreads();
      if (more) stage(next_rows, c0n, 0, 1), stage(next_rows, c0n, 3, 5);  // x, z0, z1: read no more here

      // iteration 2 from iteration 1's values (origin (r0 - 1, c0 - 4))
      auto mid = [&](const float* b) {
        return [=](int r, int c) { return b[(r - r0 + 1) * S::sM + (c - c0 + 4)]; };
      };
      const MaskedDual<decltype(mid(Z01)), decltype(mid(Z11)), E> zd1{mid(Z01), mid(Z11), H, W};
      const auto X1m = mid(X1);
      auto g1 = [=](int r, int c) { return masked_grad(M(r, c), X1m(r, c), A(r, c)); };
      // x_t on rows [r0, r0 + 33) x columns [c0, c0 + 65)
      for_region<S::MR - 1, S::MC - 1>([&](int i, int j) {
        const int r = r0 + i, c = c0 + j;
        if (E && (r >= H || c >= W)) return;
        const int b = (i + 1) * S::sM + j + 4;
        Xt[b] = zd1.x_t(r, c, X1[b], g1, p);
      });
      __syncthreads();
      if (more) stage(next_rows, c0n, 1, 3);  // m, atb

      // the update on the tile, 4 columns an item: lanes 0-15 take a row's 16
      // items, 16-31 the next row's
      for (int it = threadIdx.x; it < S::TR * S::TC / 4; it += kThreads) {
        const int rr = it >> 4, c = c0 + 4 * (it & 15), r = r0 + rr;
        if (E && (r < rn || r >= H)) continue;
        const int b = (rr + 1) * S::sM + (c - c0) + 4;
        const float4 t4 = ld4(Xt + b), td4 = ld4(Xt + b + S::sM), x4 = ld4(X1 + b), xd4 = ld4(X1 + b + S::sM);
        const float4 z04 = ld4(Z01 + b), z14 = ld4(Z11 + b);
        const float tv[5] = {t4.x, t4.y, t4.z, t4.w, Xt[b + 4]}, xv[5] = {x4.x, x4.y, x4.z, x4.w, X1[b + 4]};
        const float tdv[4] = {td4.x, td4.y, td4.z, td4.w}, xdv[4] = {xd4.x, xd4.y, xd4.z, xd4.w};
        const float z0v[4] = {z04.x, z04.y, z04.z, z04.w}, z1v[4] = {z14.x, z14.y, z14.z, z14.w};
        PdsOut o[4];
        const bool down = !E || r < H - 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cq = c + q;
          if (E && (cq < cn || cq >= W)) continue;
          const float a0 = z0v[q], a1 = z1v[q];
          auto Z0 = [=](int, int) { return a0; };
          auto Z1 = [=](int, int) { return a1; };
          const MaskedDual<decltype(Z0), decltype(Z1), E> zq{Z0, Z1, H, W};
          const bool right = !E || cq < W - 1;
          o[q] = pds_update(r, cq, H, W, p, zq, xv[q], tv[q], down ? xdv[q] : 0.f, down ? tdv[q] : 0.f,
                            right ? xv[q + 1] : 0.f, right ? tv[q + 1] : 0.f);
          st.add(o[q]);  // the second iteration against the first
        }
        const size_t g = (size_t)r * W + c;
        if ((!E || (c >= cn && c + 3 < W)) && aligned16(xo + g) && aligned16(z0o + g) && aligned16(z1o + g)) {
          *reinterpret_cast<float4*>(xo + g) = make_float4(o[0].xn, o[1].xn, o[2].xn, o[3].xn);
          *reinterpret_cast<float4*>(z0o + g) = make_float4(o[0].z0n, o[1].z0n, o[2].z0n, o[3].z0n);
          *reinterpret_cast<float4*>(z1o + g) = make_float4(o[0].z1n, o[1].z1n, o[2].z1n, o[3].z1n);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (E && (c + q < cn || c + q >= W)) continue;
            xo[g + q] = o[q].xn;
            z0o[g + q] = o[q].z0n;
            z1o[g + q] = o[q].z1n;
          }
        }
      }
    };
    if (r0 >= 2 && r0 + S::TR + 3 <= H && c0 >= 2 && c0 + S::TC + 3 <= W)
      tile(std::false_type{});
    else
      tile(std::true_type{});
    r0 = r0n, c0 = c0n, rn = rnn, cn = cnn;
  }
  block_stats(st, partials);
}

constexpr int kMaxDevices = 64;

// Once a device and process: raises the kernel's shared-memory limit (the
// masked paths launch K6 in a loop near the host's pace, so the call is
// kept off the launch) and reads the SM count; the grid's blocks.
inline cudaError_t sweepm2_blocks(int ntiles, int* blocks) {
  static std::atomic<int> sms_of[kMaxDevices];  // 0 until set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = dev < kMaxDevices ? sms_of[dev].load(std::memory_order_acquire) : 0;
  if (sms == 0) {
    err = cudaFuncSetAttribute(tv_sweepm2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SweepM2Tile::bytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sms_of[dev].store(sms, std::memory_order_release);
  }
  *blocks = std::min(ntiles, kM2BlocksPerSM * sms);
  return cudaSuccess;
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
  using S = SweepM2Tile;
  int blocks = 0;  // at most two an SM: fewer than the wrapper's partials
  cudaError_t err = sweepm2_blocks(((W + S::TC - 1) / S::TC) * ((H + S::TR - 1) / S::TR), &blocks);
  if (err != cudaSuccess) return (int)err;
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  tv_sweepm2_kernel<<<blocks, kThreads, S::bytes, (cudaStream_t)stream>>>(x, z0, z1, m, atb, xo, z0o, z1o,
                                                                          partials, H, W, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_fold<<<1, kThreads, 0, (cudaStream_t)stream>>>(partials, blocks, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
