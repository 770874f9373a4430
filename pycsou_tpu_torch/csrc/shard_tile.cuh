// Row-shard tiles staged in shared memory, for the shard kernels K14
// (tvr1.cu) and K16 (tv.cu); K11, K12 (tvr1.cu) and K6 (tvm2.cu) stage
// their tiles of a dense image with the same stage_tile and ImageRows.
//
// A row shard holds its core rows [row0, row0 + hloc) of an (H, W) image
// and R halo rows above and below from its neighbours, in three blocks
// (top, core, bottom).  Reading it through sepconv.cuh's Shard picks the
// block on every read: two compares, a pointer choice and a 64-bit
// multiply a value, which in a stencil that reads some twenty values a
// pixel cost more than the stencil.  Here a kernel resolves each row's
// pointer once (ShardRows::row) into a table in shared memory, copies its
// tile in with cp.async (16 bytes where the row allows, 4 at the margins),
// and runs from shared memory.  Shard and load_region stay as they are for
// K15 and K17.
#pragma once

#include <cstdint>

#include "sepconv.cuh"

namespace pct {

// The rows a shard holds of one image: row r's first float, or nullptr
// where it holds none (outside [row0 - R, row0 + hloc + R) or [0, H)); a
// copy reads such a row as 0, as Shard's loads do.
struct ShardRows {
  const float *top, *core, *bot;
  int row0, hloc, R, H, W;
  __device__ __forceinline__ const float* row(int r) const {
    const int l = r - row0;
    if (r < 0 || r >= H || l < -R || l >= hloc + R) return nullptr;
    return l < 0 ? top + (size_t)(l + R) * W : l < hloc ? core + (size_t)l * W : bot + (size_t)(l - hloc) * W;
  }
};

// The rows of a dense (H, W) image: row r's first float, or nullptr outside
// [0, H) (stage_tile writes such a row 0: the Gram's zero boundary, K6's
// zero outside the image).
struct ImageRows {
  const float* p;
  int H, W;
  __device__ __forceinline__ const float* row(int r) const {
    return (r < 0 || r >= H) ? nullptr : p + (size_t)r * W;
  }
};

// Origin of block b's span of len pixels (a tile's edge, K10's strip) along
// an axis of n: the last span is shifted back to end on the edge when the
// axis holds a whole span.
__device__ __forceinline__ int span_origin(int b, int len, int n) {
  const int o = b * len;
  return (n >= len && o > n - len) ? n - len : o;
}

// 16 bytes from device to shared memory by cp.async (both 16-byte aligned;
// L2 only: the tile is read once); done after copy_wait_group.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  for (int q = 0; q < 4; ++q) dst[q] = src[q];
#endif
}

// Closes the group of this thread's cp.async copies issued since the last.
__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most N of this thread's committed groups are in flight; a
// barrier then makes the copies the block's.
template <int N>
__device__ __forceinline__ void copy_wait_group() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Rows [ra, ra + NR) of a shard image, columns [cs, cs + 4 NK) with cs a
// multiple of 4, into dst (row stride s, a multiple of 4 floats; dst 16-byte
// aligned); rows[i] is row ra + i's pointer (ShardRows::row).  A 4-float
// chunk inside [0, W) whose source is 16-byte aligned is one 16-byte copy,
// any other four 4-byte copies with the columns outside [0, W) read as 0; a
// row the shard does not hold is written 0.  Items (row, chunk) are dealt
// to the NT threads in turn (NK a constant: no division by a variable).
template <int NR, int NK, int NT>
__device__ __forceinline__ void stage_tile(float* dst, int s, const float* const* rows, int cs, int W) {
  for (int it = threadIdx.x; it < NR * NK; it += NT) {
    const int i = it / NK, k = it - (it / NK) * NK;
    const float* row = rows[i];
    float* d = dst + i * s + 4 * k;
    const int c = cs + 4 * k;
    if (row == nullptr) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (c >= 0 && c + 4 <= W && (reinterpret_cast<uintptr_t>(row + c) & 15) == 0) {
      copy_async16(d, row + c);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = c + q >= 0 && c + q < W;
        copy_async(d + q, row + (in ? c + q : 0), in);
      }
    }
  }
}

// Rows [0, nr) of a window, row i from rows[i], columns [cx, cx + nc) into
// dst with any row stride s (odd for the band passes), 4 bytes a copy; a
// warp copies a row at a time, its lanes along the columns; 0 outside
// [0, W) and on rows the shard does not hold.
template <int NT>
__device__ __forceinline__ void stage_window(float* dst, int s, int nr, int nc, const float* const* rows, int cx,
                                             int W) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nr; i += NT / 32) {
    const float* row = rows[i];
    float* d = dst + i * s;
    if (row == nullptr) {
      for (int cc = lane; cc < nc; cc += 32) d[cc] = 0.f;
      continue;
    }
    for (int cc = lane; cc < nc; cc += 32) {
      const int c = cx + cc;
      const bool in = c >= 0 && c < W;
      copy_async(d + cc, row + (in ? c : 0), in);
    }
  }
}

}  // namespace pct
