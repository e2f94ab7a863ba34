// local_warp.cu — the standalone tile-reference bilinear warp of a pyramid
// level, on NVIDIA Hopper (sm_90a): out(p) = next(p + clip(flow(p), +-D)),
// separable two-tap, each (th, tw) tile warped around its own reference
// displacement (the flow at the tile centre, rounded half to even), a
// residual beyond +-local of it clamped.
//
// Replaces the Pallas TPU kernel lk_tpu/flow/pallas_kernels.py
// pallas_local_warp (_warp_kernel, _warp_core).  The plain PyTorch version is
// lk_tpu_torch/flow/warp_kernels.py local_warp_reference; both compute the
// warp of warp_tile.cuh with no halo, so they agree bit for bit.  The TPU
// kernel's aligned window DMA, lane and sublane rolls and power-of-two window
// widths are TPU layout: here the window is read by clamped address.
//
// Design: one block per (BH, BW) piece of one reference tile (a block never
// straddles two tiles, so it shares the tile's reference).  The block stages
// its (BH + 2L + 1) x (BW + 2L + 1) window of next and the fy its vertical
// pass reads, runs the vertical pass into shared memory, and the horizontal
// pass with the pixel's own fx to the output.
//
// What bounds it on this card: the compulsory traffic, next and the two flow
// planes read once and the output written once, 16 B per pixel (1080p level
// 0, 1088x1920: 33.4 MB, ~10 us at 3.35 TB/s), against ~30 f32 operations
// per pixel: memory bound.  The window halo (2L + 1 rows and columns per 32)
// is re-read from L2.

#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace {

constexpr int BH = 32;                 // output rows per block
constexpr int BW = 32;                 // output cols per block
constexpr int NT = 256;                // threads per block
constexpr int MAX_LOCAL = 8;
constexpr int FW_MAX = BW + 2 * MAX_LOCAL + 1;
constexpr int WR_MAX = BH + 2 * MAX_LOCAL + 1;

struct Params {
  const float* next;       // (H, W)
  const float* fx;         // (H, W) flow planes
  const float* fy;
  float* out;              // (H, W)
  int H, W, th, tw, nbx, nby, local;
  float max_disp;
};

__global__ void __launch_bounds__(NT)
local_warp_kernel(Params p) {
  __shared__ float sWin[WR_MAX * FW_MAX];  // window of next, WR x FW
  __shared__ float sFY[BH * FW_MAX];       // fy of the vertical pass, BH x FW
  __shared__ float sV[BH * FW_MAX];        // vertical pass, BH x FW
  const int L = p.local;
  const int FW = BW + 2 * L + 1;
  const int WR = BH + 2 * L + 1;
  const int H = p.H, W = p.W;
  const int tj = blockIdx.x / p.nbx, bx = blockIdx.x % p.nbx;
  const int ti = blockIdx.y / p.nby, by = blockIdx.y % p.nby;
  const int ty0 = ti * p.th, tx0 = tj * p.tw;    // tile origin
  const int rb = by * BH, cb = bx * BW;          // block origin in the tile
  const float D = p.max_disp;
  const float two_l = 2.0f * L;

  const size_t at = (size_t)(ty0 + p.th / 2) * W + (tx0 + p.tw / 2);
  const int wy0 = lkwarp::window_origin(ty0, p.fy[at], D, L);
  const int wx0 = lkwarp::window_origin(tx0, p.fx[at], D, L);

  lkwarp::load_window(sWin, p.next, WR, FW, wy0 + rb, wx0 + cb, H, W);
  for (int i = threadIdx.x; i < BH * FW; i += NT) {
    const int r = i / FW, c = i % FW;
    const int y = min(ty0 + rb + r, H - 1);      // rows past a ragged block
    sFY[i] = p.fy[(size_t)y * W + tx0 + min(cb + c, p.tw - 1)];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BH * FW; i += NT) {
    const int r = i / FW, c = i % FW;
    sV[i] = lkwarp::tent(sWin + r * FW + c, FW, sFY[i], rb + r, ty0, wy0, D,
                         two_l, H);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BH * BW; i += NT) {
    const int r = i / BW, c = i % BW;
    if (rb + r >= p.th || cb + c >= p.tw) continue;   // ragged tile edge
    const size_t px = (size_t)(ty0 + rb + r) * W + (tx0 + cb + c);
    p.out[px] = lkwarp::tent(sV + r * FW + c, 1, p.fx[px], cb + c, tx0, wx0,
                             D, two_l, W);
  }
}

}  // namespace

extern "C" {

// Launches one warp of an (H, W) level on `stream`; returns
// cudaGetLastError() (0 = ok).  fx, fy: row-major (H, W) flow planes.
int lk_local_warp_launch(const void* next, const void* fx, const void* fy,
                         void* out, int H, int W, int tile_h, int tile_w,
                         int local, float max_disp, void* stream) {
  if (local < 0 || local > MAX_LOCAL || tile_h < 1 || tile_w < 1 ||
      H % tile_h || W % tile_w)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.next = static_cast<const float*>(next);
  p.fx = static_cast<const float*>(fx);
  p.fy = static_cast<const float*>(fy);
  p.out = static_cast<float*>(out);
  p.H = H;
  p.W = W;
  p.th = tile_h;
  p.tw = tile_w;
  p.nbx = (tile_w + BW - 1) / BW;
  p.nby = (tile_h + BH - 1) / BH;
  p.local = local;
  p.max_disp = max_disp;
  const dim3 grid((W / tile_w) * p.nbx, (H / tile_h) * p.nby);
  local_warp_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
