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
// adds one halo row of x, g, z0 and z1 from each neighbour.  In K3, K5 and
// K13 each thread updates one pixel and reads its neighbours' inputs
// straight from global memory; the re-reads hit L1.  The outputs go to buffers separate from the
// inputs: the TPU kernels updated x, z0 and z1 in place, which is safe only
// on a grid that runs in order.  Per-block partial sums are folded by
// stats_fold.
//
// K16 stages its tile.  Read through sepconv.cuh's Shard, as K3's code, every
// one of the stencil's twenty-odd reads a pixel picked the row's block (top
// halo, core, bottom halo): two compares, a pointer choice and a 64-bit
// multiply, and x_t was computed three times a pixel; a 1024-row shard took
// 2.6-3.0x a quarter of K3.  Now a block owns 32 x 64 output pixels of the
// core, resolves each row's pointer once into a table in shared memory
// (shard_tile.cuh), copies x, g, z0 and z1 over rows [r0 - 1, r0 + 32] and
// columns [c0 - 4, c0 + 68) by cp.async (16 bytes where the row allows, 4 at
// the margins; rows the shard does not hold read as 0), computes x_t once a
// pixel on the tile grown by one row and column (pass 1), then each pixel's
// update from it (pds_update, pass 2).  Bound: the core's 7 streams; the
// staged tile is 1.2x the core's inputs, the overlap read from L2.  48 KB of
// shared memory, four blocks an SM.  Every boundary (the dual masks, the zero
// last row of the forward difference) keys to the global row and the global
// height H.  K3 keeps its own kernel and its machine code.
#include "sepconv.cuh"
#include "pds_stencil.cuh"
#include "shard_tile.cuh"

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

// K16's tile: TR x TC output pixels of the core.
// x, g, z0 and z1 are staged over rows [r0 - 1, r0 + TR] and columns
// [c0 - 4, c0 + TC + 4) (16-byte chunks; the stencil reads [c0 - 1, c0 +
// TC]), x_t over rows [r0, r0 + TR] and columns [c0, c0 + TC].  The row
// table comes first (16-byte multiple), so every staged row is 16-byte
// aligned.  About 48 KB: four blocks an SM.
struct SweepShardSmem {
  static constexpr int TR = 32, TC = 64;
  static constexpr int NR = TR + 2, NK = TC / 4 + 2, sI = 4 * NK, nI = NR * sI;
  static constexpr int sT = TC + 1;
  static constexpr int ptrs = 4 * NR;  // x, g, z0, z1 rows
  static constexpr size_t bytes = ptrs * sizeof(const float*) + (4 * nI + (TR + 1) * sT) * sizeof(float);
  static_assert(ptrs * sizeof(const float*) % 16 == 0 && ptrs <= kThreads, "one pointer a thread, aligned after");
};

__global__ void __launch_bounds__(kThreads, 4)
tv_sweep_shard_kernel(PCT_IMAGE(x), PCT_IMAGE(z0), PCT_IMAGE(z1), PCT_IMAGE(g),
                      float* __restrict__ xo, float* __restrict__ z0o, float* __restrict__ z1o,
                      float* __restrict__ partials, int row0, int hloc, int R, int H, int W,
                      PdsParams p) {
  using S = SweepShardSmem;
  extern __shared__ float4 smem4[];
  const float** rows = reinterpret_cast<const float**>(smem4);  // image a's row r0 - 1 + i at a * NR + i
  float* In = reinterpret_cast<float*>(rows + S::ptrs);         // x, g, z0, z1, nI floats each
  float* T = In + 4 * S::nI;
  const int r0 = row0 + blockIdx.y * S::TR, c0 = blockIdx.x * S::TC;
  if (threadIdx.x < S::ptrs) {
    const int a = threadIdx.x / S::NR, i = threadIdx.x - a * S::NR;
    const ShardRows src{a == 0 ? xt : a == 1 ? gt : a == 2 ? z0t : z1t, a == 0 ? x : a == 1 ? g : a == 2 ? z0 : z1,
                        a == 0 ? xb : a == 1 ? gb : a == 2 ? z0b : z1b, row0, hloc, R, H, W};
    rows[threadIdx.x] = src.row(r0 - 1 + i);
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) stage_tile<S::NR, S::NK, kThreads>(In + a * S::nI, S::sI, rows + a * S::NR, c0 - 4, W);
  copy_wait();
  __syncthreads();

  auto at = [&](int a) {
    const float* b = In + a * S::nI;
    return [=](int r, int c) { return b[(r - r0 + 1) * S::sI + (c - c0 + 4)]; };
  };
  const auto X = at(0), G = at(1);
  const MaskedDual<decltype(at(2)), decltype(at(3))> zd{at(2), at(3), H, W};
  // pass 1: x_t once a pixel, on the tile grown by one row and column
  for (int i = threadIdx.x; i < (S::TR + 1) * S::sT; i += kThreads) {
    const int rr = i / S::sT, cc = i - (i / S::sT) * S::sT, r = r0 + rr, c = c0 + cc;
    if (r >= H || r > row0 + hloc || c >= W) continue;
    T[i] = zd.x_t(r, c, X(r, c), G, p);
  }
  __syncthreads();
  // pass 2: the update of the tile's pixels of the core
  Stats6 st;
  st.zero();
  for (int i = threadIdx.x; i < S::TR * S::TC; i += kThreads) {
    const int rr = i / S::TC, cc = i % S::TC, r = r0 + rr, c = c0 + cc;
    if (r >= row0 + hloc || c >= W) continue;
    const float* t = T + rr * S::sT + cc;
    const bool down = r < H - 1, right = c < W - 1;
    const PdsOut o = pds_update(r, c, H, W, p, zd, X(r, c), t[0], down ? X(r + 1, c) : 0.f, down ? t[S::sT] : 0.f,
                                right ? X(r, c + 1) : 0.f, right ? t[1] : 0.f);
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
  // at most the wrapper's (hloc / 32) x (W / 32) blocks of partials
  using S = SweepShardSmem;
  dim3 grid((W + S::TC - 1) / S::TC, (hloc + S::TR - 1) / S::TR);
  const PdsParams p{tau, sigma, rho, lam, nonneg, iso};
  cudaError_t err = allow_smem(tv_sweep_shard_kernel, S::bytes);
  if (err != cudaSuccess) return (int)err;
  tv_sweep_shard_kernel<<<grid, kThreads, S::bytes, (cudaStream_t)stream>>>(
      xt, x, xb, z0t, z0, z0b, z1t, z1, z1b, gt, g, gb, xo, z0o, z1o, partials, row0, hloc, R, H, W,
      p);
  err = cudaGetLastError();
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
