// warp_tile.cuh — the tile-reference separable warp that the dense LK kernels
// share (fused_lk_level.cu, fused_level_pre.cu, local_warp.cu).
//
// Counterpart of the Pallas bodies _warp_start / _warp_finish / _tent_gather
// of lk_tpu/flow/pallas_kernels.py, and of the plain version
// lk_tpu_torch/flow/lk_kernels.py warp_region.  A reference region (a tile,
// or a tile with its halo) whose origin is (Y0, X0) warps `next` by its flow
// around one reference displacement, d0 = round_half_even(clip(ref, +-D)):
//
//   window origin   wy0 = Y0 + d0y - L   (wx0 likewise), edge-clamped reads;
//   vertical pass   gy  = clip((row + Y0) + clip(fy, +-D), 0, H-1),
//                   rel = clip((gy - wy0) - row, 0, 2L),
//                   v   = (1 - f) * win[row + di] + f * win[row + di + 1],
//                   di = floor(rel), f = rel - di; the window column j takes
//                   the fy of region column min(j, region width - 1);
//   horizontal pass the same along columns on v, with the pixel's own fx.
//
// `row` is the pixel's index in the region (the Pallas kernel's row iota),
// so a residual beyond +-L of the reference clamps.  Every operation is f32
// in this order; the kernels are built with --fmad=false, so the products
// round as in the plain version.  The window may be stored as f32 or bf16
// (local_warp.cu's bf16 instances): a bf16 element is widened to f32 as it
// is read, which is exact, so the arithmetic is the same.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lkwarp {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Staging with cp.async (fused_lk_level.cu, local_warp.cu).  A build with
// LKWARP_NO_COPIES defined to 1 leaves the copies out, for measurement only:
// the kernel then runs on whatever shared memory holds.
#ifndef LKWARP_NO_COPIES
#define LKWARP_NO_COPIES 0
#endif

// Elements of T that one 16-byte copy moves: 4 floats, 8 bf16.
template <typename T>
__host__ __device__ constexpr int per16() { return 16 / (int)sizeof(T); }

// Row stride of a staged row of n elements of T: room for the 0 .. E-1
// elements between the 16-byte-aligned column at or below its first element
// and that element (E = per16<T>(); (n + 6) / 4 * 4 for floats).
template <typename T = float>
__host__ __device__ constexpr int staged_stride(int n) {
  return (n + 2 * per16<T>() - 2) / per16<T>() * per16<T>();
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if !LKWARP_NO_COPIES
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
#endif
}

template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
#if !LKWARP_NO_COPIES
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#endif
}

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Stage ROWS x N elements of a row-major plane (H x W) of T (float or bf16)
// from (y0, x0) into s: row r at s + r * staged_stride<T>(N) + off,
// off = x0 & (E - 1) with E = per16<T>(), rows and columns edge-clamped.
// Returns off.  Each row is copied from the aligned column x0 - off in
// 16-byte chunks (E elements) of cp.async where the rows are 16-byte
// aligned.  A float block whose columns all lie inside the plane copies
// every chunk so; any other float block copies element by element, a
// 4-byte cp.async each by clamped address.  A bf16 block copies by chunk
// wherever the rows are aligned and the chunk lies inside the plane, and
// any other chunk element by element: a 2-byte element is below cp.async's
// least size (4 B), so the chunk's E clamped loads are issued together
// before their stores (the compiler may not move a load across a store to
// shared memory, which could alias the plane).
template <int ROWS, int N, int NT, typename T>
__device__ __forceinline__ int stage(T* s, const T* plane, int y0, int x0,
                                     int H, int W) {
  constexpr int E = per16<T>();
  constexpr int STRIDE = staged_stride<T>(N), NC = STRIDE / E;
  const int off = x0 & (E - 1), xa = x0 - off;
  const bool aligned = (W & (E - 1)) == 0 &&
                       (reinterpret_cast<size_t>(plane) & 15) == 0;
  if constexpr (sizeof(T) == 4) {
    if (aligned && xa >= 0 && xa + STRIDE <= W) {
      for (int i = threadIdx.x; i < ROWS * NC; i += NT) {
        const int r = i / NC, ch = i - r * NC;
        const int y = clampi(y0 + r, 0, H - 1);
        cp_async16(s + r * STRIDE + ch * E,
                   plane + (size_t)y * W + xa + ch * E);
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * N; i += NT) {
        const int r = i / N, c = i - r * N;
        const int y = clampi(y0 + r, 0, H - 1), x = clampi(x0 + c, 0, W - 1);
        cp_async4(s + r * STRIDE + off + c, plane + (size_t)y * W + x);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * NC; i += NT) {
      const int r = i / NC, ch = i - r * NC;
      const T* row = plane + (size_t)clampi(y0 + r, 0, H - 1) * W;
      T* d = s + r * STRIDE + ch * E;
      const int xc = xa + ch * E;
      if (aligned && xc >= 0 && xc + E <= W) {
        cp_async16(d, row + xc);
      } else {
        T v[E];
#pragma unroll
        for (int u = 0; u < E; ++u) v[u] = row[clampi(xc + u, 0, W - 1)];
#if !LKWARP_NO_COPIES
#pragma unroll
        for (int u = 0; u < E; ++u) d[u] = v[u];
#endif
      }
    }
  }
  return off;
}

// Row (column) origin of a region's warp window: region origin + rounded,
// clipped reference displacement - L.
__device__ __forceinline__ int window_origin(int region0, float ref, float D,
                                             int L) {
  return region0 + (int)rintf(clampf(ref, -D, D)) - L;
}

// Stage rows x cols of plane (H, W) from (oy, ox) into s (row stride cols),
// edge-clamped, with every thread of the block.
__device__ __forceinline__ void load_window(float* s, const float* plane,
                                            int rows, int cols, int oy, int ox,
                                            int H, int W) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    s[i] = plane[(size_t)clampi(oy + r, 0, H - 1) * W + clampi(ox + c, 0, W - 1)];
  }
}

// One two-tap tent along an axis.  p: the window element (float or bf16) at
// the pixel's own index (row of the vertical pass, column of the
// horizontal), stride: the window's step along the axis; d: the pixel's flow
// component; pos: its index in the region; origin: the region origin;
// worigin: the window origin; n: the level's extent along the axis.
template <typename T>
__device__ __forceinline__ float tent(const T* p, int stride, float d,
                                      int pos, int origin, int worigin,
                                      float D, float two_l, int n) {
  const float g = clampf((float)(pos + origin) + clampf(d, -D, D), 0.0f,
                         (float)(n - 1));
  const float rel = clampf((g - (float)worigin) - (float)pos, 0.0f, two_l);
  const float di = floorf(rel);
  const float f = rel - di;
  const T* q = p + (int)di * stride;
  return (1.0f - f) * to_f32(q[0]) + f * to_f32(q[stride]);
}

}  // namespace lkwarp
