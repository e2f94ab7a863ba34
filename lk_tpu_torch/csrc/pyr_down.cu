// pyr_down.cu — cv.pyrDown of N same-shape f32 planes in one launch, on
// NVIDIA Hopper (sm_90a): the 5-tap [1,4,6,4,1]/16 filter on both axes with
// BORDER_REFLECT_101, even-pixel decimation, (ceil(H/2), ceil(W/2)) out.
//
// Replaces the Pallas TPU kernel lk_tpu/flow/pallas_kernels.py
// _pallas_pyr_down (_pyr_down_kernel; pallas_pyr_down_pair and
// pallas_pyr_down_one are its N = 2 and N = 1 forms).  The TPU kernel's
// column pass is a bf16 band matmul; this kernel is held bit for bit to the
// port's exact f32 plain version instead, lk_tpu_torch/ops/blur.py
// pyr_down_reference: rows filtered and decimated first, then columns, each
// output ((((x0*t0 + x1*t1) + x2*t2) + x3*t3) + x4*t4) with every product
// rounded (built with --fmad=false).
//
// Design: one block per (TH, TW) output tile of one plane (blockIdx.z).  The
// block stages the (2TH+3, 2TW+3) input rows and columns its outputs read,
// with REFLECT_101 as clamped-reflected addresses at the plane's true edges
// (the plain version's _reflect101_taps, including its n == 1 clamp), then
// runs the vertical pass over every staged column into shared memory and the
// horizontal pass from there to the outputs.  No padded copy exists.
//
// What bounds it on this card: the compulsory traffic, each input read once
// and each quarter-size output written once (1080p level 0 of a pair,
// 2 x 1088x2048: 17.8 MB in, 4.5 MB out, ~6.7 us at 3.35 TB/s) against 27
// f32 operations per output pixel (9 for each of the two vertical-pass values
// it owns, 9 for the horizontal pass): memory bound.  Each block reads 1.12x its
// share of the input (the 3-row and 3-column tile halo, re-read from L2).

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;                 // output rows per block
constexpr int TW = 64;                 // output cols per block
constexpr int IH = 2 * TH + 3;         // staged input rows
constexpr int IW = 2 * TW + 3;         // staged input cols
constexpr int NT = 256;                // threads per block
constexpr float T0 = 1.0f / 16.0f, T1 = 4.0f / 16.0f, T2 = 6.0f / 16.0f;

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);        // n == 1 has no reflection partner
}

__device__ __forceinline__ float taps5(const float* v, int stride) {
  float a = v[0] * T0;
  a = a + v[stride] * T1;
  a = a + v[2 * stride] * T2;
  a = a + v[3 * stride] * T1;
  return a + v[4 * stride] * T0;
}

__global__ void __launch_bounds__(NT)
pyr_down_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
                int W, int OH, int OW) {
  __shared__ float in[IH][IW];
  __shared__ float vt[TH][IW];
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const float* src = x + (size_t)blockIdx.z * H * W;
  float* dst = out + (size_t)blockIdx.z * OH * OW;
  const int iy0 = 2 * oy0 - 2;
  const int ix0 = 2 * ox0 - 2;

  for (int i = threadIdx.x; i < IH * IW; i += NT) {
    const int r = i / IW;
    const int c = i - r * IW;
    in[r][c] = src[(size_t)reflect101(iy0 + r, H) * W + reflect101(ix0 + c, W)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * IW; i += NT) {
    const int r = i / IW;
    const int c = i - r * IW;
    vt[r][c] = taps5(&in[2 * r][c], IW);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * TW; i += NT) {
    const int r = i / TW;
    const int c = i - r * TW;
    const int oy = oy0 + r;
    const int ox = ox0 + c;
    if (oy < OH && ox < OW) dst[(size_t)oy * OW + ox] = taps5(&vt[r][2 * c], 1);
  }
}

}  // namespace

extern "C" {

// Launches one pyrDown over n contiguous (H, W) planes on `stream`; out is
// (n, ceil(H/2), ceil(W/2)).  Returns cudaGetLastError() (0 = ok).
int lk_pyr_down_launch(const void* x, void* out, int n, int H, int W,
                       void* stream) {
  if (n < 1 || n > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const dim3 grid((OW + TW - 1) / TW, (OH + TH - 1) / TH, n);
  pyr_down_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W, OH, OW);
  return (int)cudaGetLastError();
}

}  // extern "C"
