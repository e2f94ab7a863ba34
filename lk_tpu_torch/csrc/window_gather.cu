// window_gather.cu — the batched sparse tracker's per-point window gather on
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of lk_tpu/flow/pallas_kernels.py
//   make_frame_band_gather   (per-frame band DMAs, frame-major points)
//   make_point_window_gather (per-point DMAs, any point order)
// which lk_tpu/flow/sparse.py _gather_windows_pallas calls.  Both compute
// the same function; this kernel works per point, so it takes the points in
// any order and covers both.  The plain PyTorch version is
// lk_tpu_torch/flow/sparse.py gather_windows_reference: full-frame
// scharr_derivatives of the folded prev level, then index gathers — the JAX
// package's pallas_windows=False path.
//
// Per point p, from the folded prev and next levels (FH, FW) f32:
//   raw[p] (3, win_h+1, win_w+1): prev, Scharr ix, Scharr iy at rows
//          cy..cy+win_h, cols cx..cx+win_w;
//   sw[p]  (sw_h, sw_w): next at rows sy.., cols sx.. .
// Corners are clamped into the array as jax.lax.dynamic_slice clamps them.
//
// Design: one block per point.  The block loads the prev window plus its
// 1-pixel Scharr halo, (win_h+3) x (win_w+3), into shared memory, with
// REFLECT_101 only where the stencil meets the folded array's own edge (as
// the full-frame Scharr pads it), and computes ix and iy there in
// scharr_derivatives' exact order: smooth [3,10,3]/16 across ((t0 + t1) +
// t2), then the difference [-1/2, 0, 1/2] with its zero tap, each product
// rounded (built with --fmad=false).  The result is bit-equal to the plain
// version.  The superwindow is copied with consecutive threads on
// consecutive columns.  The Pallas kernels' 8/128 alignment remainders, band
// DMAs and (24, 128)/(32, 128) lane layouts are Mosaic workarounds and are
// dropped.
//
// What bounds it on this card: at the serving shape (64 streams x 20 points
// = 1,280 points per level launch, win 15, superwindow 32x48) it writes
// 1,280 x (3*16*16 + 32*48) x 4 B = 11.8 MB and reads ~1,280 x (18*18 +
// 32*48) x 4 B = 9.5 MB: ~6.4 us at 3.35 TB/s; the arithmetic (~20 f32
// operations per window pixel) is negligible.  At that size launch latency
// dominates.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;                // threads per block (one point)

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

struct Args {
  const float* prev;
  const float* next;
  const int* cy;
  const int* cx;
  const int* sy;
  const int* sx;
  float* raw;
  float* sw;
  int FH, FW, win_h, win_w, sw_h, sw_w;
};

__global__ void __launch_bounds__(NT) window_gather_kernel(Args a) {
  extern __shared__ float tile[];                   // (win_h+3) x (win_w+3)
  const int p = blockIdx.x;
  const int th = a.win_h + 3, tw = a.win_w + 3;
  const int oh = a.win_h + 1, ow = a.win_w + 1;
  const int y0 = min(max(a.cy[p], 0), a.FH - oh);   // dynamic_slice clamp
  const int x0 = min(max(a.cx[p], 0), a.FW - ow);
  for (int i = threadIdx.x; i < th * tw; i += NT) {
    const int r = i / tw;
    const int c = i - r * tw;
    const int gy = reflect101(y0 - 1 + r, a.FH);
    const int gx = reflect101(x0 - 1 + c, a.FW);
    tile[i] = a.prev[(size_t)gy * a.FW + gx];
  }
  __syncthreads();
  float* raw = a.raw + (size_t)p * 3 * oh * ow;
  for (int i = threadIdx.x; i < oh * ow; i += NT) {
    const int r = i / ow + 1;                       // tile coordinates
    const int c = i - (i / ow) * ow + 1;
    const float* t = tile + r * tw + c;
    // ix: smooth across rows at columns c-1 and c+1, then the difference
    float sl = t[-tw - 1] * 0.1875f;
    sl = sl + t[-1] * 0.625f;
    sl = sl + t[tw - 1] * 0.1875f;
    float sc = t[-tw] * 0.1875f;
    sc = sc + t[0] * 0.625f;
    sc = sc + t[tw] * 0.1875f;
    float sr = t[-tw + 1] * 0.1875f;
    sr = sr + t[1] * 0.625f;
    sr = sr + t[tw + 1] * 0.1875f;
    float ix = sl * -0.5f;
    ix = ix + sc * 0.0f;
    ix = ix + sr * 0.5f;
    // iy: smooth along columns at rows r-1 and r+1, then the difference
    float su = t[-tw - 1] * 0.1875f;
    su = su + t[-tw] * 0.625f;
    su = su + t[-tw + 1] * 0.1875f;
    float sm = t[-1] * 0.1875f;
    sm = sm + t[0] * 0.625f;
    sm = sm + t[1] * 0.1875f;
    float sd = t[tw - 1] * 0.1875f;
    sd = sd + t[tw] * 0.625f;
    sd = sd + t[tw + 1] * 0.1875f;
    float iy = su * -0.5f;
    iy = iy + sm * 0.0f;
    iy = iy + sd * 0.5f;
    raw[i] = t[0];
    raw[oh * ow + i] = ix;
    raw[2 * oh * ow + i] = iy;
  }
  const int sy0 = min(max(a.sy[p], 0), a.FH - a.sw_h);
  const int sx0 = min(max(a.sx[p], 0), a.FW - a.sw_w);
  float* sw = a.sw + (size_t)p * a.sw_h * a.sw_w;
  for (int i = threadIdx.x; i < a.sw_h * a.sw_w; i += NT) {
    const int r = i / a.sw_w;
    const int c = i - r * a.sw_w;
    sw[i] = a.next[(size_t)(sy0 + r) * a.FW + sx0 + c];
  }
}

}  // namespace

extern "C" {

// Launches the gather of n points on `stream`; returns cudaGetLastError()
// (0 = ok).  prev/next: (FH, FW) f32 row-major; cy/cx/sy/sx: (n,) int32;
// raw: (n, 3, win_h+1, win_w+1) f32; sw: (n, sw_h, sw_w) f32.
int lk_window_gather_launch(const void* prev, const void* next, const void* cy,
                            const void* cx, const void* sy, const void* sx,
                            void* raw, void* sw, int n, int FH, int FW,
                            int win_h, int win_w, int sw_h, int sw_w,
                            void* stream) {
  if (n < 0 || win_h < 1 || win_w < 1 || FH < win_h + 1 || FW < win_w + 1 ||
      FH < 2 || FW < 2 || sw_h < 1 || sw_w < 1 || FH < sw_h || FW < sw_w)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Args a{static_cast<const float*>(prev), static_cast<const float*>(next),
         static_cast<const int*>(cy),     static_cast<const int*>(cx),
         static_cast<const int*>(sy),     static_cast<const int*>(sx),
         static_cast<float*>(raw),        static_cast<float*>(sw),
         FH, FW, win_h, win_w, sw_h, sw_w};
  const size_t smem = (size_t)(win_h + 3) * (win_w + 3) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  window_gather_kernel<<<n, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
