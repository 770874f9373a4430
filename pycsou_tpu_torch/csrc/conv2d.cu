// K1 and K2: separable low-rank 'same' 2-D convolution and its fused Gram.
//
// K1 sepconv2d replaces pycsou_tpu/kernels/conv2d.py sepconv2d_sweep
// (_sepconv_kernel): y = sum_k C(v_k) R(u_k) x for a rank <= 4 PSF.
// K2 sepgram2d replaces sepgram2d_sweep (_sepgram_kernel): g = A^H A x, or
// s (A^H A x - atb) with s folded into the adjoint row taps.
//
// On Hopper both are bound by device-memory traffic: K1 reads x and writes
// y once (2 image streams), K2 adds atb (3 streams), and t = A x stays in
// shared memory.  Each block owns a 32 x 32 output tile and loads its own
// halo (the TPU sweep carried the previous tile in scratch instead; blocks
// here run in no order).  The halo re-reads come from L2.
#include "sepconv.cuh"

namespace pct {

__global__ void __launch_bounds__(kThreads)
sepconv2d_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W,
                 const float* __restrict__ taps, int rank, int Ku, int Kv, int ou, int ov) {
  extern __shared__ float smem[];
  const int ntaps = rank * (Ku + Kv);
  float* su = smem;
  float* sv = su + rank * Ku;
  load_taps(smem, taps, ntaps);
  Region out{nullptr, (int)blockIdx.y * kTile, (int)blockIdx.x * kTile, kTile, kTile};
  Region in = source_region(out, Ku, Kv, ou, ov, smem + ntaps);
  float* tmp = in.p + in.nr * in.nc;
  out.p = tmp + out.nr * in.nc;
  load_region(in, x, H, W);
  __syncthreads();
  sep_same_pass(in, out, tmp, su, sv, rank, Ku, Kv, ou, ov);
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = out.r0 + i / kTile, c = out.c0 + i % kTile;
    if (r < H && c < W) y[(size_t)r * W + c] = out.p[i];
  }
}

__global__ void __launch_bounds__(kThreads)
sepgram2d_kernel(const float* __restrict__ x, const float* __restrict__ atb, float* __restrict__ g,
                 int H, int W, const float* __restrict__ taps, int rank, int Ku, int Kv, int ouf,
                 int ovf, int oua, int ova, float atb_coef) {
  extern __shared__ float smem[];
  const int ntaps = 2 * rank * (Ku + Kv);
  load_taps(smem, taps, ntaps);
  const GramTaps gt{smem, smem + rank * Ku, smem + rank * (Ku + Kv),
                    smem + rank * (2 * Ku + Kv), rank, Ku, Kv, ouf, ovf, oua, ova};
  Region G{smem + ntaps, (int)blockIdx.y * kTile, (int)blockIdx.x * kTile, kTile, kTile};
  gram_into(x, H, W, gt, G, G.p + kTile * kTile);
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = G.r0 + i / kTile, c = G.c0 + i % kTile;
    if (r < H && c < W) {
      const size_t o = (size_t)r * W + c;
      g[o] = atb ? G.p[i] - atb_coef * __ldg(atb + o) : G.p[i];
    }
  }
}

}  // namespace pct

using namespace pct;

extern "C" {

// y = sum_k C(v_k) R(u_k) x; taps = [u (rank, Ku) | v (rank, Kv)].
int pct_sepconv2d(const float* x, float* y, int H, int W, const float* taps, int rank, int Ku,
                  int Kv, int ou, int ov, void* stream) {
  const int in_r = kTile + Ku - 1, in_c = kTile + Kv - 1;
  const size_t floats = rank * (Ku + Kv) + in_r * in_c + kTile * in_c + kTile * kTile;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(sepconv2d_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  sepconv2d_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(x, y, H, W, taps, rank, Ku,
                                                                     Kv, ou, ov);
  return (int)cudaGetLastError();
}

// g = A^H A x (atb null) or A^H A x - atb_coef * atb, with A^H's taps
// already scaled by the caller; taps = [uf | vf | ua | va].
int pct_sepgram2d(const float* x, const float* atb, float* g, int H, int W, const float* taps,
                  int rank, int Ku, int Kv, int ouf, int ovf, int oua, int ova, float atb_coef,
                  void* stream) {
  const size_t floats =
      2 * rank * (Ku + Kv) + kTile * kTile + gram_scratch_floats(kTile, kTile, Ku, Kv);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(sepgram2d_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  sepgram2d_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, atb, g, H, W, taps, rank, Ku, Kv, ouf, ovf, oua, ova, atb_coef);
  return (int)cudaGetLastError();
}

}  // extern "C"
