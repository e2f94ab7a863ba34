// finish.cu — the serving finish on NVIDIA Hopper (sm_90a): (N, H, W) u8 or
// f32 frames -> f32, optional tone curve, 3x3 Gaussian [1/4, 1/2, 1/4]^2 with
// BORDER_REFLECT_101.
//
// Replaces the Pallas TPU kernel lk_tpu/ops/pallas_finish.py fused_finish
// (_finish_kernel).  The plain PyTorch version is
// lk_tpu_torch/ops/finish.py fused_finish_reference: convert,
// contrast_brightness ((x - b0) * k + b1, clipped to 0..255, in that order),
// gaussian_blur3 (horizontal pass first, each axis (0.25l + 0.5c) + 0.25r).
//
// What bounds it on this card: the compulsory traffic, 1 B (u8) or 4 B in
// and 4 B out per pixel, ~6 f32 operations per pixel.  At the serving chunk
// (64 streams x 16 frames x 483x860 = 425.3 M px, u8 in) that is 2.13 GB,
// 0.635 ms at 3.35 TB/s, against 2.6 GFLOP, 0.04 ms at 67 TFLOP/s: memory
// bound, and four fifths of the bytes are the f32 output.
//
// Design: no shared memory and no block barrier.  A warp owns a strip of
// R = 8 rows by 128 columns of one frame; each lane owns 4 adjacent
// columns.  The lane loads the strip's R + 2 input rows (the rows
// above and below reflected) up front, 4 columns as one 4-byte word (u8) or
// one 16-byte float4 (f32), so every load of the strip is in flight at
// once; the warp's two edge lanes also load the one column left and right
// of the warp.  Row by row it tones the values, takes its +-1 column
// neighbours from the adjacent lanes (__shfl_up/down_sync), runs the
// horizontal pass and keeps the last three horizontally filtered rows in
// registers for the vertical pass, whose rows go out as one streaming
// (__stcs) 16-byte store per lane.  The input's 2-row strip halo is the
// only read twice (2/R of the 1-byte input).  Work items (frame, strip,
// column segment) are flattened into a one-dimensional grid, a warp each,
// four warps a block, so any frame count is accepted.  A width that is not
// a multiple of 4, or an unaligned base, takes the same kernel with
// per-column loads and stores.  REFLECT_101 at the frame's columns: column
// -1 is column 1 and column W is column W - 2, the lane's own or its
// neighbour's value.  Slower at the serving chunk on the card: 16-row
// strips (127 registers, two 256-thread blocks an SM), 4-row strips, a
// grid of resident blocks walking the items, plain stores.
//
// Rounding: built with --fmad=false, so each product rounds before it is
// added, as in the plain version's eager elementwise ops; the tone curve is
// applied to every input value (halo and reflected ones included) before
// the horizontal pass, then the vertical pass, each in the plain version's
// order: the result is bit-equal to the plain version with and without the
// tone curve.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 128;                // threads per block
constexpr int WPB = NT / 32;           // warps per block
constexpr int GW = 4;                  // columns per lane
constexpr int SEG = 32 * GW;           // columns per warp
constexpr int R = 8;                   // output rows per strip
constexpr unsigned FULL = 0xffffffffu;

struct Tone {
  int on;
  float k, b0, b1;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);        // rows past n+1 feed no output
}

// Columns c0..c0+3 of one input row: one aligned vector load (VEC), or four
// loads by column clamped to the row.
template <bool VEC>
__device__ __forceinline__ uchar4 load4(const uint8_t* row, int c0, int W) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uchar4*>(row + c0));
  } else {
    return make_uchar4(row[min(c0, W - 1)], row[min(c0 + 1, W - 1)],
                       row[min(c0 + 2, W - 1)], row[min(c0 + 3, W - 1)]);
  }
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int c0, int W) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(row + c0));
  } else {
    return make_float4(row[min(c0, W - 1)], row[min(c0 + 1, W - 1)],
                       row[min(c0 + 2, W - 1)], row[min(c0 + 3, W - 1)]);
  }
}

__device__ __forceinline__ float4 widen(uchar4 v) {
  return make_float4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ float4 widen(float4 v) { return v; }

__device__ __forceinline__ float tone_px(float v, const Tone& t) {
  if (t.on) {
    v = v - t.b0;
    v = v * t.k;
    v = v + t.b1;
    v = fminf(fmaxf(v, 0.0f), 255.0f);
  }
  return v;
}

// One axis of the blur: (0.25 l + 0.5 c) + 0.25 r, in this order.
__device__ __forceinline__ float blur3(float l, float c, float r) {
  float a = 0.25f * l;
  a = a + 0.5f * c;
  return a + 0.25f * r;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
finish_kernel(const T* __restrict__ x, float* __restrict__ out, int H, int W,
              int strips, int segs, long long items, Tone tone) {
  using Raw = decltype(load4<VEC>(x, 0, 0));
  const long long it = (long long)blockIdx.x * WPB + (threadIdx.x >> 5);
  if (it >= items) return;             // whole warps: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const size_t plane = (size_t)H * W;
  const int seg = (int)(it % segs);
  const long long fs = it / segs;
  const int y0 = (int)(fs % strips) * R;
  const size_t f = (size_t)(fs / strips);
  const T* src = x + f * plane;
  float* dst = out + f * plane;
  const int c0 = (seg * 32 + lane) * GW;
  const bool live = c0 < W;                // the lane has a column
  const int rows = min(R, H - y0);         // output rows of the strip
  const int ce = lane == 0 ? max(c0 - 1, 0) : min(c0 + GW, W - 1);

  // input rows y0-1 .. y0+R, reflected (rows past the strip's need are
  // clamped reads, never used)
  Raw raw[R + 2];
  T edge[R + 2];
#pragma unroll
  for (int k = 0; k < R + 2; ++k) {
    const T* row = src + (size_t)reflect101(y0 - 1 + k, H) * W;
    raw[k] = live ? load4<VEC>(row, c0, W) : Raw{};
    edge[k] = (lane == 0 || lane == 31) ? row[ce] : T(0);
  }

  float4 hm = make_float4(0.f, 0.f, 0.f, 0.f), hc = hm;
#pragma unroll
  for (int k = 0; k < R + 2; ++k) {
    float4 v = widen(raw[k]);
    v.x = tone_px(v.x, tone);
    v.y = tone_px(v.y, tone);
    v.z = tone_px(v.z, tone);
    v.w = tone_px(v.w, tone);
    const float e = tone_px((float)edge[k], tone);
    float l = __shfl_up_sync(FULL, v.w, 1);
    float r = __shfl_down_sync(FULL, v.x, 1);
    if (lane == 0) l = e;
    if (lane == 31) r = e;
    float in[GW + 2] = {l, v.x, v.y, v.z, v.w, r};
    if (c0 == 0) in[0] = in[2];              // x[-1] = x[1]
#pragma unroll
    for (int j = 0; j < GW; ++j)
      if (c0 + j == W - 1) in[j + 2] = in[j];  // x[W] = x[W-2]
    const float4 h = make_float4(blur3(in[0], in[1], in[2]),
                                 blur3(in[1], in[2], in[3]),
                                 blur3(in[2], in[3], in[4]),
                                 blur3(in[3], in[4], in[5]));
    if (k >= 2 && k - 2 < rows && live) {
      const float4 o = make_float4(blur3(hm.x, hc.x, h.x),
                                   blur3(hm.y, hc.y, h.y),
                                   blur3(hm.z, hc.z, h.z),
                                   blur3(hm.w, hc.w, h.w));
      float* q = dst + (size_t)(y0 + k - 2) * W + c0;
      if constexpr (VEC) {
        __stcs(reinterpret_cast<float4*>(q), o);
      } else {
        const float ov[GW] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int j = 0; j < GW; ++j)
          if (c0 + j < W) __stcs(q + j, ov[j]);
      }
    }
    hm = hc;
    hc = h;
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// One launch of finish_kernel<T, VEC>: a warp per work item.
template <typename T, bool VEC>
int launch(const void* x, void* out, int n, int H, int W, Tone tone,
           cudaStream_t s) {
  const int strips = (H + R - 1) / R;
  const int segs = (W + SEG - 1) / SEG;
  const long long items = (long long)n * strips * segs;
  const long long blocks = (items + WPB - 1) / WPB;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  finish_kernel<T, VEC><<<(unsigned)blocks, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(out), H, W, strips, segs,
      items, tone);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one finish over n frames on `stream`; returns a CUDA error code
// (0 = ok).  x: (n, H, W) contiguous, uint8 when is_u8 else float32.
int lk_finish_launch(const void* x, int is_u8, void* out, int n, int H, int W,
                     int contrast, float k, float b0, float b1, void* stream) {
  if (n < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const Tone tone{contrast, k, b0, b1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = W % GW == 0 && aligned(x, is_u8 ? 4 : 16) &&
                   aligned(out, 16);
  if (is_u8)
    return vec ? launch<uint8_t, true>(x, out, n, H, W, tone, s)
               : launch<uint8_t, false>(x, out, n, H, W, tone, s);
  return vec ? launch<float, true>(x, out, n, H, W, tone, s)
             : launch<float, false>(x, out, n, H, W, tone, s);
}

}  // extern "C"
