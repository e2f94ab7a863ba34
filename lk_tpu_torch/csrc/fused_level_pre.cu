// fused_level_pre.cu — one inverse-compositional dense Lucas–Kanade iteration
// of a pyramid level on precomputed gradients and structure tensor, on NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lk_tpu/flow/pallas_kernels.py
// make_fused_lk_level (_fused_level_kernel): the fused level of
// fused_grads_in_kernel=False, whose prologue (Scharr, the three box sums of
// A, the min-eig gate and inv_det) runs outside the kernel.  The plain
// PyTorch version is lk_tpu_torch/flow/warp_kernels.py
// fused_lk_level_precomputed_reference.  n_iters is one launch per iteration
// over ping-pong flow buffers (the wrapper's loop), Jacobi across tiles.
//
// Semantics (the TPU kernel's own, in f32): per reference tile (th, tw) its
// extended region (tile +- 8) reads prev, ix and iy as precomputed on the
// level and edge-replicated outside it, and the flow: the current flow
// inside the level, the initial flow edge-replicated outside it — except the
// right halo band's first `spill` columns, which from the second iteration on
// carry the current flow's edge column (the TPU kernel writes 128-aligned
// widths, so its rightmost tile refreshes them; this kernel reproduces that).
// The region is warped (warp_tile.cuh) around the flow at the region centre;
// r = (jw - prev) - (ix*fx + iy*fy); the two 15x15 box sums of ix*r and iy*r
// in tap order (rows, then columns); b = box + A v; (du, dv) = adj(A) b *
// inv_det; the new flow clipped to +-max_disp.  No eps freeze, no stats.
//
// Rounding: built with --fmad=false, box sums in tap order: the kernel and
// the plain version agree bit for bit.
//
// What bounds it on this card (1080p top level of the precomputed-A path,
// 136x240, one pair, 6 iterations): the compulsory traffic of the call is
// ~1.6 MB (prev, next, ix, iy, the four A planes and the initial flow read
// once, the flow written once; the iterations' ping-pong stays in the 50 MB
// L2), ~0.47 us at 3.35 TB/s, and 115 f32 operations per pixel per iteration
// (warp 30, residual 5, products 2, two box sums 56, A v 8, solve 8, update
// and clip 6), ~0.34 us at 67 TFLOP/s: at this size the launches (~3-5 us
// each) bound it.  The design is
// PR 1's fused level without the Scharr and the three A box sums: every
// intermediate (flow, warp, residual, column sums) stays in shared memory.

#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace {

using lkwarp::clampf;
using lkwarp::clampi;

constexpr int HALO = 8;
constexpr int BH = 32;                 // output rows per block
constexpr int BW = 32;                 // output cols per block
constexpr int EH = BH + 2 * HALO;      // extended (halo) rows per block
constexpr int EW = BW + 2 * HALO;
constexpr int NT = 256;                // threads per block
constexpr int PER_T = BH * BW / NT;    // output pixels per thread
constexpr int MAX_LOCAL = 8;

struct Params {
  const float* next;       // (H, W) planes, row-major
  const float* prev;
  const float* ix;
  const float* iy;
  const float* a11;
  const float* a12;
  const float* a22;
  const float* inv_det;
  const float* cur;        // (2, H, W) current flow
  const float* init;       // (2, H, W) initial flow
  float* out;              // (2, H, W)
  int H, W;
  int th, tw;              // reference tile
  int nbx, nby;            // blocks per tile along x / y
  int local, win_k, spill;
  float max_disp;
};

// Flow component c at level position (y, x), which may lie outside the level.
__device__ __forceinline__ float flow_at(const Params& p, int c, int y, int x) {
  const size_t plane = (size_t)c * p.H * p.W;
  if (y >= 0 && y < p.H && x >= 0 && x < p.W + p.spill)
    return p.cur[plane + (size_t)y * p.W + min(x, p.W - 1)];
  return p.init[plane + (size_t)clampi(y, 0, p.H - 1) * p.W
                + clampi(x, 0, p.W - 1)];
}

__host__ __device__ inline int smem_floats(int local) {
  const int fw = EW + 2 * local + 1;   // columns of the vertical warp pass
  const int wr = EH + 2 * local + 1;   // rows of the warp window
  const int warp = wr * fw, sums = BH * EW;
  return 4 * EH * EW + EH * fw + EH * EW + EH * fw + (warp > sums ? warp : sums);
}

__global__ void __launch_bounds__(NT)
fused_level_pre_kernel(Params p) {
  extern __shared__ float smem[];
  const int L = p.local;
  const int FW = EW + 2 * L + 1;
  const int WR = EH + 2 * L + 1;
  float* sP = smem;                        // prev, EH x EW
  float* sIX = sP + EH * EW;
  float* sIY = sIX + EH * EW;
  float* sFX = sIY + EH * EW;              // EH x EW
  float* sFY = sFX + EH * EW;              // EH x FW
  float* sR = sFY + EH * FW;               // residual, EH x EW
  float* sV = sR + EH * EW;                // vertical pass, EH x FW
  float* sWin = sV + EH * FW;              // warp window, WR x FW
  float* sS = sWin;                        // column sums, BH x EW (reuses)

  const int tid = threadIdx.x;
  const int tj = blockIdx.x / p.nbx, bx = blockIdx.x % p.nbx;
  const int ti = blockIdx.y / p.nby, by = blockIdx.y % p.nby;
  const int H = p.H, W = p.W;
  const int ty0 = ti * p.th, tx0 = tj * p.tw;    // tile origin
  const int Y0 = ty0 - HALO, X0 = tx0 - HALO;    // tile extended origin
  const int eth = p.th + 2 * HALO, etw = p.tw + 2 * HALO;
  const int rb = by * BH, cb = bx * BW;          // block origin in the tile
  const float D = p.max_disp;
  const float two_l = 2.0f * L;

  // --- reference displacement: the current flow at the region centre -------
  const size_t at = (size_t)(Y0 + eth / 2) * W + (X0 + etw / 2);
  const int wy0 = lkwarp::window_origin(Y0, p.cur[(size_t)H * W + at], D, L);
  const int wx0 = lkwarp::window_origin(X0, p.cur[at], D, L);

  // --- loads: prev / ix / iy, flow, warp window -----------------------------
  for (int i = tid; i < EH * EW; i += NT) {
    const int r = i / EW, c = i % EW;
    const size_t q = (size_t)clampi(Y0 + rb + r, 0, H - 1) * W
                     + clampi(X0 + cb + c, 0, W - 1);
    sP[i] = p.prev[q];
    sIX[i] = p.ix[q];
    sIY[i] = p.iy[q];
  }
  for (int i = tid; i < EH * FW; i += NT) {
    const int r = i / FW, c = i % FW;
    const int y = Y0 + rb + r;
    const int x = X0 + min(cb + c, etw - 1);   // edge column of the tile ext
    sFY[i] = flow_at(p, 1, y, x);
    if (c < EW) sFX[r * EW + c] = flow_at(p, 0, y, x);
  }
  lkwarp::load_window(sWin, p.next, WR, FW, wy0 + rb, wx0 + cb, H, W);
  __syncthreads();

  // --- vertical warp pass ---------------------------------------------------
  for (int i = tid; i < EH * FW; i += NT) {
    const int r = i / FW, c = i % FW;
    sV[i] = lkwarp::tent(sWin + r * FW + c, FW, sFY[i], rb + r, Y0, wy0, D,
                         two_l, H);
  }
  __syncthreads();

  // --- horizontal warp pass and the IC residual -----------------------------
  for (int i = tid; i < EH * EW; i += NT) {
    const int r = i / EW, c = i % EW;
    const float fx = sFX[i], fy = sFY[r * FW + c];
    const float jw = lkwarp::tent(sV + r * FW + c, 1, fx, cb + c, X0, wx0, D,
                                  two_l, W);
    sR[i] = (jw - sP[i]) - (sIX[i] * fx + sIY[i] * fy);
  }
  __syncthreads();

  // --- two box sums: column sums in shared memory, row sums in registers ----
  float acc[2][PER_T];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* g = q == 0 ? sIX : sIY;
    for (int i = tid; i < BH * EW; i += NT) {
      const int ro = i / EW, c = i % EW;
      float s = 0.0f;
      for (int d = 1; d <= p.win_k; ++d) {
        const int e = (ro + d) * EW + c;
        const float v = g[e] * sR[e];
        s = (d == 1) ? v : s + v;
      }
      sS[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER_T; ++m) {
      const int o = tid + m * NT;
      const float* row = sS + (o / BW) * EW + (o % BW);
      float s = row[1];
      for (int d = 2; d <= p.win_k; ++d) s = s + row[d];
      acc[q][m] = s;
    }
    __syncthreads();
  }

  // --- A v correction and the 2x2 solve --------------------------------------
#pragma unroll
  for (int m = 0; m < PER_T; ++m) {
    const int o = tid + m * NT;
    const int ro = o / BW, co = o % BW;
    if (rb + ro >= p.th || cb + co >= p.tw) continue;   // ragged tile edge
    const size_t px = (size_t)(ty0 + rb + ro) * W + (tx0 + cb + co);
    const float a11 = p.a11[px], a12 = p.a12[px], a22 = p.a22[px];
    const float invd = p.inv_det[px];
    const float fx = sFX[(ro + HALO) * EW + co + HALO];
    const float fy = sFY[(ro + HALO) * FW + co + HALO];
    const float b1 = (acc[0][m] + a11 * fx) + a12 * fy;
    const float b2 = (acc[1][m] + a12 * fx) + a22 * fy;
    const float du = (a12 * b2 - a22 * b1) * invd;
    const float dv = (a12 * b1 - a11 * b2) * invd;
    p.out[px] = clampf(fx + du, -D, D);
    p.out[(size_t)H * W + px] = clampf(fy + dv, -D, D);
  }
}

}  // namespace

extern "C" {

// Launches one iteration on `stream`; returns cudaGetLastError() (0 = ok).
// All planes row-major (H, W); cur, init and out (2, H, W).
int lk_fused_level_pre_launch(const void* next, const void* prev,
                              const void* ix, const void* iy, const void* a11,
                              const void* a12, const void* a22,
                              const void* inv_det, const void* cur,
                              const void* init, void* out, int H, int W,
                              int tile_h, int tile_w, int local, int win_k,
                              int spill, float max_disp, void* stream) {
  if (local < 0 || local > MAX_LOCAL || win_k < 1 || win_k > 2 * HALO - 1 ||
      tile_h < 1 || tile_w < 1 || H % tile_h || W % tile_w || spill < 0 ||
      spill > HALO)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.next = static_cast<const float*>(next);
  p.prev = static_cast<const float*>(prev);
  p.ix = static_cast<const float*>(ix);
  p.iy = static_cast<const float*>(iy);
  p.a11 = static_cast<const float*>(a11);
  p.a12 = static_cast<const float*>(a12);
  p.a22 = static_cast<const float*>(a22);
  p.inv_det = static_cast<const float*>(inv_det);
  p.cur = static_cast<const float*>(cur);
  p.init = static_cast<const float*>(init);
  p.out = static_cast<float*>(out);
  p.H = H;
  p.W = W;
  p.th = tile_h;
  p.tw = tile_w;
  p.nbx = (tile_w + BW - 1) / BW;
  p.nby = (tile_h + BH - 1) / BH;
  p.local = local;
  p.win_k = win_k;
  p.spill = spill;
  p.max_disp = max_disp;
  const size_t smem = (size_t)smem_floats(local) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fused_level_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W / tile_w) * p.nbx, (H / tile_h) * p.nby);
  fused_level_pre_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
