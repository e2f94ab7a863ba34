// local_warp.cu — the standalone tile-reference bilinear warp of a pyramid
// level, on NVIDIA Hopper (sm_90a): out(p) = next(p + clip(flow(p), +-D)),
// separable two-tap, each (th, tw) tile warped around its own reference
// displacement (the flow at the tile centre, rounded half to even), a
// residual beyond +-local of it clamped.
//
// Replaces the Pallas TPU kernel lk_tpu/flow/pallas_kernels.py
// pallas_local_warp (_warp_kernel, _warp_core), for both of its window types:
// `next` stored as f32, or as bf16 (window_dtype=bfloat16, the
// bf16_warp_window option), where the selects and the lerp stay f32.  The
// plain PyTorch version is lk_tpu_torch/flow/warp_kernels.py
// local_warp_reference; both compute the warp of warp_tile.cuh with no halo,
// so they agree bit for bit (a bf16 element widens to f32 exactly).  The TPU
// kernel's aligned window DMA, lane and sublane rolls and power-of-two window
// widths are TPU layout: here the window is staged by cp.async.
//
// What bounds it on this card: the compulsory traffic, next and the two flow
// planes read once and the output written once, 16 B per pixel with an f32
// next (1080p level 0, 1088x1920: 33.4 MB, ~10 us at 3.35 TB/s), 14 B with a
// bf16 one (~8.7 us), against ~30 f32 operations per pixel: memory bound.
// The caller rounds next to bf16 once per level call, outside the kernel, as
// lk_tpu pads and casts outside its own, so the kernel's read of next halves.
// The window halo (2L + 1 rows and columns per block) is re-read from L2.
//
// Design: one block per (16, 32) piece of one reference tile (a block never
// straddles two tiles, so it shares the tile's reference), 128 threads;
// local is a template parameter, so every window extent and index division
// is a compile-time constant.  Before its one wait, a block issues every
// load it makes: the tile reference, then each thread's flow into
// registers (the 8 fy of its vertical-pass column strip, the 4 fx of its
// output column strip), then the (16 + 2L + 1) x (32 + 2L + 1) window of
// next with cp.async (warp_tile.cuh stage: 16 B copies, 4 floats or 8 bf16,
// where the rows are aligned and the block's columns (a bf16 chunk's
// columns) lie inside the level; elsewhere by clamped address, a 4 B
// cp.async per float, or a bf16 chunk's 8 loads issued together).  The
// window stays in next's storage type in shared memory and widens to f32
// as it is read.  The vertical pass is one thread per (window column, 8
// rows), walking down the column; the horizontal pass one thread per
// (output column, 4 rows), a warp per 32 columns, its stores coalesced and
// streaming (__stcs: the output is not read again by this launch).
// Measured at path B's L0-L2 on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py phase 6): the bf16 instances about as fast as the f32 ones
// (21.1-21.3 against 20.8 us); at L1 and L2 the time is latency, not bytes.

#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace {

constexpr int MAX_LOCAL = 8;
constexpr int BH = 16;   // output rows per block
constexpr int BW = 32;   // output columns per block: a warp's lanes
constexpr int RH = 4;    // output rows per thread of the horizontal pass
constexpr int RV = 8;    // rows per thread of the vertical pass
constexpr int NT = BW * BH / RH;  // threads per block

// T: the storage type of next and of its window, float or __nv_bfloat16.
template <typename T>
struct Params {
  const T* next;           // (H, W)
  const float* fx;         // (H, W) flow planes
  const float* fy;
  float* out;              // (H, W)
  int H, W, th, tw, nbx, nby;
  float max_disp;
};

template <int L, typename T>
__global__ void __launch_bounds__(NT)
local_warp_kernel(Params<T> p) {
  constexpr int FW = BW + 2 * L + 1;           // window columns
  constexpr int WR = BH + 2 * L + 1;           // window rows
  constexpr int WS = lkwarp::staged_stride<T>(FW);
  constexpr int NV = FW * (BH / RV);           // vertical-pass threads
  constexpr float two_l = 2.0f * L;
  static_assert(BH % RV == 0 && NV <= NT, "one vertical strip per thread");
  __shared__ __align__(16) T sWin[WR * WS];      // window of next
  __shared__ float sV[BH * FW];                  // vertical pass

  const int tid = threadIdx.x;
  const int H = p.H, W = p.W;
  const int tj = blockIdx.x / p.nbx, bx = blockIdx.x - tj * p.nbx;
  const int ti = blockIdx.y / p.nby, by = blockIdx.y - ti * p.nby;
  const int ty0 = ti * p.th, tx0 = tj * p.tw;    // tile origin
  const int rb = by * BH, cb = bx * BW;          // block origin in the tile
  const float D = p.max_disp;

  // --- every load before the wait: the reference first, the window's
  // origin waits on it -----------------------------------------------------
  const size_t at = (size_t)(ty0 + p.th / 2) * W + (tx0 + p.tw / 2);
  const float rfy = p.fy[at], rfx = p.fx[at];

  // vertical strip: window column vc, block rows vr0 .. vr0 + RV - 1; the
  // column takes the fy of tile column min(cb + vc, tw - 1), rows past a
  // ragged block clamp to the level
  const int vs = tid / FW, vc = tid - vs * FW, vr0 = vs * RV;
  float fy[RV];
  if (tid < NV) {
    const float* src = p.fy + tx0 + min(cb + vc, p.tw - 1);
#pragma unroll
    for (int u = 0; u < RV; ++u)
      fy[u] = src[(size_t)min(ty0 + rb + vr0 + u, H - 1) * W];
  }
  // output strip: column hc, block rows hr0 .. hr0 + RH - 1
  const int hc = tid % BW, hr0 = tid / BW * RH;
  const bool col_in = cb + hc < p.tw;
  const size_t px0 = (size_t)(ty0 + rb + hr0) * W + (tx0 + cb + hc);
  float fx[RH];
#pragma unroll
  for (int u = 0; u < RH; ++u)
    fx[u] = col_in && rb + hr0 + u < p.th ? p.fx[px0 + (size_t)u * W] : 0.0f;

  const int wy0 = lkwarp::window_origin(ty0, rfy, D, L);
  const int wx0 = lkwarp::window_origin(tx0, rfx, D, L);
  const T* sWo = sWin + lkwarp::stage<WR, FW, NT>(sWin, p.next, wy0 + rb,
                                                  wx0 + cb, H, W);
  lkwarp::cp_async_wait_all();
  __syncthreads();

  // --- vertical pass, down the strip; stored after the walk ---------------
  if (tid < NV) {
    float v[RV];
#pragma unroll
    for (int u = 0; u < RV; ++u) {
      const int r = vr0 + u;
      v[u] = lkwarp::tent(sWo + r * WS + vc, WS, fy[u], rb + r, ty0, wy0, D,
                          two_l, H);
    }
#pragma unroll
    for (int u = 0; u < RV; ++u) sV[(vr0 + u) * FW + vc] = v[u];
  }
  __syncthreads();

  // --- horizontal pass with the pixel's own fx, to the output -------------
#pragma unroll
  for (int u = 0; u < RH; ++u) {
    const int r = hr0 + u;
    if (!col_in || rb + r >= p.th) break;        // ragged tile edge
    __stcs(p.out + px0 + (size_t)u * W, lkwarp::tent(
        sV + r * FW + hc, 1, fx[u], cb + hc, tx0, wx0, D, two_l, W));
  }
}

template <int L, typename T>
cudaError_t launch(const Params<T>& p, const dim3& grid, cudaStream_t st) {
  local_warp_kernel<L, T><<<grid, NT, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_level(const void* next, const void* fx, const void* fy, void* out,
                 int H, int W, int tile_h, int tile_w, int local,
                 float max_disp, void* stream) {
  if (local < 0 || local > MAX_LOCAL || tile_h < 1 || tile_w < 1 ||
      H % tile_h || W % tile_w)
    return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.next = static_cast<const T*>(next);
  p.fx = static_cast<const float*>(fx);
  p.fy = static_cast<const float*>(fy);
  p.out = static_cast<float*>(out);
  p.H = H;
  p.W = W;
  p.th = tile_h;
  p.tw = tile_w;
  p.nbx = (tile_w + BW - 1) / BW;
  p.nby = (tile_h + BH - 1) / BH;
  p.max_disp = max_disp;
  const dim3 grid((W / tile_w) * p.nbx, (H / tile_h) * p.nby);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (local) {
    case 0: return (int)launch<0>(p, grid, st);
    case 1: return (int)launch<1>(p, grid, st);
    case 2: return (int)launch<2>(p, grid, st);
    case 3: return (int)launch<3>(p, grid, st);
    case 4: return (int)launch<4>(p, grid, st);
    case 5: return (int)launch<5>(p, grid, st);
    case 6: return (int)launch<6>(p, grid, st);
    case 7: return (int)launch<7>(p, grid, st);
    default: return (int)launch<8>(p, grid, st);
  }
  static_assert(MAX_LOCAL == 8, "extend the dispatch");
}

}  // namespace

extern "C" {

// Launches one warp of an (H, W) level on `stream`; returns
// cudaGetLastError() (0 = ok).  next: row-major (H, W) f32; fx, fy:
// row-major (H, W) f32 flow planes.
int lk_local_warp_launch(const void* next, const void* fx, const void* fy,
                         void* out, int H, int W, int tile_h, int tile_w,
                         int local, float max_disp, void* stream) {
  return launch_level<float>(next, fx, fy, out, H, W, tile_h, tile_w, local,
                             max_disp, stream);
}

// The same with next stored as bf16 (row-major (H, W) __nv_bfloat16).
int lk_local_warp_bf16_launch(const void* next, const void* fx,
                              const void* fy, void* out, int H, int W,
                              int tile_h, int tile_w, int local,
                              float max_disp, void* stream) {
  return launch_level<__nv_bfloat16>(next, fx, fy, out, H, W, tile_h, tile_w,
                                     local, max_disp, stream);
}

}  // extern "C"
