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
// Design: one block per (TH, TW) output tile of one frame.  The block loads
// the (TH+2, TW+2) input tile into shared memory, converting (and toning)
// as it loads, with the REFLECT_101 border read by clamped-reflected address
// at the frame's true edges (x[-1] = x[1], x[n] = x[n-2]); the horizontal
// pass writes a (TH+2, TW) tile to shared memory and the vertical pass
// writes the outputs.  The Pallas version's double-buffered DMA and
// (32, 128) padding are TPU scheduling and are not carried over.
//
// Rounding: built with --fmad=false, so each product rounds before it is
// added, as in the plain version's eager elementwise ops; the result is
// bit-equal to the plain version with and without the tone curve.
//
// What bounds it on this card: the compulsory traffic, 1 B (u8) or 4 B in
// and 4 B out per pixel, ~6 f32 operations per pixel.  At the serving chunk
// (64 streams x 16 frames x 483x860 = 425.3 M px, u8 in) that is 2.13 GB,
// 0.635 ms at 3.35 TB/s, against 2.6 GFLOP, 0.04 ms at 67 TFLOP/s: memory
// bound.  The design reads each input byte once from device memory (the
// 1-pixel tile halo re-reads hit L2) and writes each output once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;                 // output rows per block
constexpr int TW = 128;                // output cols per block
constexpr int NT = 256;                // threads per block

struct Tone {
  int on;
  float k, b0, b1;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);        // rows/cols past n+1 feed no output
}

__device__ __forceinline__ float load(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load(const float* p) { return *p; }

template <typename T>
__global__ void __launch_bounds__(NT)
finish_kernel(const T* __restrict__ x, float* __restrict__ out, int H, int W,
              Tone tone) {
  __shared__ float in[TH + 2][TW + 2];
  __shared__ float hz[TH + 2][TW];
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  const T* src = x + (size_t)blockIdx.z * plane;
  float* dst = out + (size_t)blockIdx.z * plane;

  for (int i = threadIdx.x; i < (TH + 2) * (TW + 2); i += NT) {
    const int r = i / (TW + 2);
    const int c = i - r * (TW + 2);
    const int gy = reflect101(y0 - 1 + r, H);
    const int gx = reflect101(x0 - 1 + c, W);
    float v = load(src + (size_t)gy * W + gx);
    if (tone.on) {
      v = v - tone.b0;
      v = v * tone.k;
      v = v + tone.b1;
      v = fminf(fmaxf(v, 0.0f), 255.0f);
    }
    in[r][c] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (TH + 2) * TW; i += NT) {
    const int r = i / TW;
    const int c = i - r * TW;
    float a = 0.25f * in[r][c];
    a = a + 0.5f * in[r][c + 1];
    hz[r][c] = a + 0.25f * in[r][c + 2];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * TW; i += NT) {
    const int r = i / TW;
    const int c = i - r * TW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (gy < H && gx < W) {
      float a = 0.25f * hz[r][c];
      a = a + 0.5f * hz[r + 1][c];
      dst[(size_t)gy * W + gx] = a + 0.25f * hz[r + 2][c];
    }
  }
}

}  // namespace

extern "C" {

// Launches one finish over n frames on `stream`; returns cudaGetLastError()
// (0 = ok).  x: (n, H, W) contiguous, uint8 when is_u8 else float32.
int lk_finish_launch(const void* x, int is_u8, void* out, int n, int H, int W,
                     int contrast, float k, float b0, float b1, void* stream) {
  if (n < 1 || H < 2 || W < 2 || n > 65535) return (int)cudaErrorInvalidValue;
  const Tone tone{contrast, k, b0, b1};
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    finish_kernel<uint8_t><<<grid, NT, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<float*>(out), H, W, tone);
  else
    finish_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), H, W, tone);
  return (int)cudaGetLastError();
}

}  // extern "C"
