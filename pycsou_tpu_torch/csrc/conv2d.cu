// K1 and K2: separable low-rank 'same' 2-D convolution and its fused Gram.
//
// K1 sepconv2d replaces pycsou_tpu/kernels/conv2d.py sepconv2d_sweep
// (_sepconv_kernel): y = sum_k C(v_k) R(u_k) x for a rank <= 4 PSF.
// K2 sepgram2d replaces sepgram2d_sweep (_sepgram_kernel): g = A^H A x, or
// s (A^H A x - atb) with s folded into the adjoint row taps.  K18
// (kernels/sepgram.py sepgram_apply) launches K2's kernel without atb.
//
// On Hopper both are bound by device-memory traffic once the passes are
// register-blocked (sepconv.cuh): K1 reads x and writes y once (2 image
// streams), K2 adds atb (3 streams), and t = A x stays in shared memory.
// Each block owns a 32 x 32 output tile and loads its own halo (the TPU
// sweep carried the previous tile in scratch instead; blocks here run in no
// order).  The halo re-reads come from L2.  The taps come by value in the
// kernel's parameters, padded to K (7, 15 or 31), the template parameter.
#include "sepconv.cuh"

namespace pct {

template <int K>
__global__ void __launch_bounds__(kThreads, gram_min_blocks(K))
sepconv2d_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W, SepTaps<K> t) {
  extern __shared__ float smem[];
  Region out{nullptr, (int)blockIdx.y * kTile, (int)blockIdx.x * kTile, kTile, kTile, kTile + 1};
  const Region in = source_region(out, K, t.ou, t.ov, smem);
  float* tmp0 = in.p + in.nr * in.s;
  const int ntmp = pass_tmp_floats(kTile, in.nc);
  out.p = tmp0 + (t.rank > 1 ? 2 : 1) * ntmp;
  load_region(in, x, H, W);
  __syncthreads();
  sep_same_pass<K>(in, out, tmp0, tmp0 + ntmp, t, NoCrop{});
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int rr = i / kTile, cc = i % kTile;
    const int r = out.r0 + rr, c = out.c0 + cc;
    if (r < H && c < W) y[(size_t)r * W + c] = out.p[rr * out.s + cc];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, gram_min_blocks(K))
sepgram2d_kernel(const float* __restrict__ x, const float* __restrict__ atb, float* __restrict__ g,
                 int H, int W, GramTaps<K> gt, float atb_coef) {
  extern __shared__ float smem[];
  const Region G{smem, (int)blockIdx.y * kTile, (int)blockIdx.x * kTile, kTile, kTile, kTile + 1};
  gram_into<K>(x, H, W, gt, G, G.p + kTile * G.s);
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int rr = i / kTile, cc = i % kTile;
    const int r = G.r0 + rr, c = G.c0 + cc;
    if (r < H && c < W) {
      const size_t o = (size_t)r * W + c;
      const float v = G.p[rr * G.s + cc];
      g[o] = atb ? v - atb_coef * __ldg(atb + o) : v;
    }
  }
}

}  // namespace pct

using namespace pct;

namespace {

template <int K>
int launch_sepconv2d(const float* x, float* y, int H, int W, const float* taps, int rank, int Ku,
                     int Kv, int ou, int ov, cudaStream_t s) {
  const int in_r = kTile + K - 1, in_c = kTile + K - 1;
  const size_t floats = in_r * odd_stride(in_c) + (rank > 1 ? 2 : 1) * pass_tmp_floats(kTile, in_c) +
                        kTile * (kTile + 1);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(sepconv2d_kernel<K>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  sepconv2d_kernel<K><<<grid, kThreads, bytes, s>>>(
      x, y, H, W, sep_taps<K>(taps, taps + rank * Ku, rank, Ku, Kv, ou, ov));
  return (int)cudaGetLastError();
}

template <int K>
int launch_sepgram2d(const float* x, const float* atb, float* g, int H, int W, const float* taps,
                     int rank, int Ku, int Kv, int ouf, int ovf, int oua, int ova, float atb_coef,
                     cudaStream_t s) {
  const size_t floats = kTile * (kTile + 1) + gram_scratch_floats(kTile, kTile, K, rank);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = allow_smem(sepgram2d_kernel<K>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  sepgram2d_kernel<K><<<grid, kThreads, bytes, s>>>(
      x, atb, g, H, W, gram_taps<K>(taps, rank, Ku, Kv, ouf, ovf, oua, ova), atb_coef);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = sum_k C(v_k) R(u_k) x; taps = [u (rank, Ku) | v (rank, Kv)] in host
// memory.
int pct_sepconv2d(const float* x, float* y, int H, int W, const float* taps, int rank, int Ku,
                  int Kv, int ou, int ov, void* stream) {
#define CALL(K) launch_sepconv2d<K>(x, y, H, W, taps, rank, Ku, Kv, ou, ov, (cudaStream_t)stream)
  PCT_DISPATCH_TAPS(Ku, Kv, CALL)
#undef CALL
}

// g = A^H A x (atb null) or A^H A x - atb_coef * atb, with A^H's taps
// already scaled by the caller; taps = [uf | vf | ua | va] in host memory.
int pct_sepgram2d(const float* x, const float* atb, float* g, int H, int W, const float* taps,
                  int rank, int Ku, int Kv, int ouf, int ovf, int oua, int ova, float atb_coef,
                  void* stream) {
#define CALL(K)                                                                              \
  launch_sepgram2d<K>(x, atb, g, H, W, taps, rank, Ku, Kv, ouf, ovf, oua, ova, atb_coef, \
                      (cudaStream_t)stream)
  PCT_DISPATCH_TAPS(Ku, Kv, CALL)
#undef CALL
}

}  // extern "C"
