// fused_lk_level.cu — one inverse-compositional dense Lucas–Kanade iteration
// over a pyramid level, for K frame pairs, on NVIDIA Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of lk_tpu/flow/pallas_kernels.py:
//   make_fused_lk_level_grads_resident_batched (_fused_level_grads_resident_batched_kernel)
//   make_fused_lk_level_grads_batched          (_fused_level_grads_batched_kernel)
//   make_fused_lk_level_grads_resident         (_fused_level_grads_resident_kernel)
//   make_fused_lk_level_grads                  (_fused_level_grads_kernel)
// as one kernel with switches: K pairs (blockIdx.z; K = 1 is the single-pair
// form), coarse-in flow, stats output.  n_iters is one launch per iteration
// over ping-pong flow buffers (the wrapper's loop): a Jacobi step needs the
// grid-wide barrier between iterations.  The plain PyTorch version is
// lk_tpu_torch/flow/lk_kernels.py fused_lk_level_reference.
//
// Semantics (the TPU kernels' own, in f32): per reference tile (th, tw) the
// warp window is centred on round_half_even(clip(ref, +-max_disp)), ref being
// the flow at the tile centre (twice the dominant coarse tap on coarse-in
// levels); the tile's 8-pixel halo is warped with that same reference, so a
// thread block never straddles two reference tiles.  Separable two-tap warp
// (warp_tile.cuh: vertical pass first, residual clamped to +-local), exact
// Scharr of edge-replicated prev, 15x15 box sums, min-eig gate, 2x2 solve.
// Flow on the halo: the current flow inside the level, the edge-replicated
// initial flow outside it; on coarse-in levels upsample2_linear's taps (x2)
// of the edge-clamped coarse planes.  All borders are read by clamped address.
//
// Rounding: built with --fmad=false (no FMA contraction), so every product
// rounds before it is added, as in the plain version's eager elementwise ops;
// sqrtf and '/' are IEEE (no --use_fast_math); box sums add in tap order.
// The kernel and the plain version agree bit for bit by construction, and
// each pair's result does not depend on K.
//
// What bounds it on this card (1080p level 0, 1088x2048, one pair): the
// compulsory traffic is ~51 MB (prev, next, coarse flow in; flow, min_eig,
// valid out), ~15 us at 3.35 TB/s; the arithmetic is 236 f32 operations per
// output pixel per iteration (five 15x15 box sums 140, gate and solve 38,
// warp 32, Scharr 16, residual and products 10), ~0.53 GFLOP, ~7.8 us at
// 67 TFLOP/s: the bound is the bytes.  What this simple design is bound by
// is shared-memory traffic and latency: each block loads a 48x48
// extended region (2.25x its 32x32 outputs) and a 59x59 warp window, and the
// box sums read shared memory ~600 times per output pixel.  The design keeps
// every intermediate (gradients, flow, warp, residual, column sums) in
// shared memory and registers, so device memory sees only the compulsory
// bytes plus halo re-reads that hit L2.  Making it fast (TMA loads, running
// box sums, a persistent grid, CUDA graphs) is later work.

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
  const float* prev;       // pair f at prev + f * prev_stride, (H, W)
  const float* next;
  long long prev_stride;
  long long next_stride;
  const float* cur;        // (K, 2, H, W) current flow; null when coarse
  const float* init;       // (K, 2, H, W) initial flow, or (K, 2, CH, CW)
  float* out;              // (K, 2, H, W)
  float* min_eig;          // (K, H, W) or null
  unsigned char* valid;    // (K, H, W) or null
  int H, W, CH, CW;
  int th, tw;              // reference tile
  int nbx, nby;            // blocks per tile along x / y
  int coarse, local, win_k;
  float max_disp, eig_thr;
};

// Flow component c of pair k at frame position (y, x), which may lie
// outside the level.
__device__ float flow_at(const Params& p, int k, int c, int y, int x) {
  if (p.coarse) {
    const float* pl = p.init + ((size_t)k * 2 + c) * p.CH * p.CW;
    const int ly = (y - 1) >> 1;       // floor((y - 1) / 2), also for y < 1
    const int lx = (x - 1) >> 1;
    const float wly = (y & 1) ? 0.75f : 0.25f, why = (y & 1) ? 0.25f : 0.75f;
    const float wlx = (x & 1) ? 0.75f : 0.25f, whx = (x & 1) ? 0.25f : 0.75f;
    const int y0 = clampi(ly, 0, p.CH - 1), y1 = clampi(ly + 1, 0, p.CH - 1);
    const int x0 = clampi(lx, 0, p.CW - 1), x1 = clampi(lx + 1, 0, p.CW - 1);
    // columns first, then rows; the x2 flow scale rides on the row weights
    const float t0 = wlx * pl[y0 * p.CW + x0] + whx * pl[y0 * p.CW + x1];
    const float t1 = wlx * pl[y1 * p.CW + x0] + whx * pl[y1 * p.CW + x1];
    return (2.0f * wly) * t0 + (2.0f * why) * t1;
  }
  const size_t plane = ((size_t)k * 2 + c) * p.H * p.W;
  if (y >= 0 && y < p.H && x >= 0 && x < p.W)
    return p.cur[plane + (size_t)y * p.W + x];
  return p.init[plane + (size_t)clampi(y, 0, p.H - 1) * p.W
                + clampi(x, 0, p.W - 1)];
}

__host__ __device__ inline int smem_floats(int local) {
  const int fw = EW + 2 * local + 1;   // columns of the vertical warp pass
  const int wr = EH + 2 * local + 1;   // rows of the warp window
  const int warp = wr * fw + EH * fw, sums = BH * EW;
  const int scratch = warp > sums ? warp : sums;
  return (EH + 2) * (EW + 2) + 3 * EH * EW + EH * fw + EH * EW + scratch;
}

__global__ void __launch_bounds__(NT)
fused_lk_level_kernel(Params p) {
  extern __shared__ float smem[];
  const int L = p.local;
  const int FW = EW + 2 * L + 1;
  const int WR = EH + 2 * L + 1;
  const int PS = EW + 2;                   // row stride of sP
  float* sP = smem;                        // prev, (EH + 2) x (EW + 2)
  float* sIX = sP + (EH + 2) * PS;         // EH x EW
  float* sIY = sIX + EH * EW;
  float* sFX = sIY + EH * EW;              // EH x EW
  float* sFY = sFX + EH * EW;              // EH x FW
  float* sR = sFY + EH * FW;               // residual, EH x EW
  float* sWin = sR + EH * EW;              // warp window, WR x FW
  float* sV = sWin + WR * FW;              // vertical pass, EH x FW
  float* sS = sWin;                        // column sums, BH x EW (reuses)

  const int tid = threadIdx.x;
  const int k = blockIdx.z;
  const int tj = blockIdx.x / p.nbx, bx = blockIdx.x % p.nbx;
  const int ti = blockIdx.y / p.nby, by = blockIdx.y % p.nby;
  const int H = p.H, W = p.W;
  const int ty0 = ti * p.th, tx0 = tj * p.tw;    // tile origin
  const int Y0 = ty0 - HALO, X0 = tx0 - HALO;    // tile extended origin
  const int eth = p.th + 2 * HALO, etw = p.tw + 2 * HALO;
  const int rb = by * BH, cb = bx * BW;          // block origin in the tile
  const float D = p.max_disp;
  const float* prev = p.prev + (size_t)k * p.prev_stride;
  const float* next = p.next + (size_t)k * p.next_stride;

  // --- tile reference displacement ---------------------------------------
  float rfx, rfy;
  if (p.coarse) {
    const int cy = clampi(ti * (p.th / 2) + (eth / 2 + 1) / 2 - 4, 0, p.CH - 1);
    const int cx = clampi(tj * (p.tw / 2) + (etw / 2 + 1) / 2 - 4, 0, p.CW - 1);
    const float* c0 = p.init + (size_t)k * 2 * p.CH * p.CW;
    rfx = 2.0f * c0[cy * p.CW + cx];
    rfy = 2.0f * c0[(size_t)p.CH * p.CW + cy * p.CW + cx];
  } else {
    const size_t at = (size_t)(Y0 + eth / 2) * W + (X0 + etw / 2);
    const float* c0 = p.cur + (size_t)k * 2 * H * W;
    rfx = c0[at];
    rfy = c0[(size_t)H * W + at];
  }
  const int wy0 = lkwarp::window_origin(Y0, rfy, D, L);
  const int wx0 = lkwarp::window_origin(X0, rfx, D, L);

  // --- loads: prev (+1 Scharr border), flow, warp window --------------------
  for (int i = tid; i < (EH + 2) * PS; i += NT) {
    const int r = i / PS, c = i % PS;
    const int y = clampi(Y0 + rb + r - 1, 0, H - 1);
    const int x = clampi(X0 + cb + c - 1, 0, W - 1);
    sP[i] = prev[(size_t)y * W + x];
  }
  for (int i = tid; i < EH * FW; i += NT) {
    const int r = i / FW, c = i % FW;
    const int y = Y0 + rb + r;
    const int x = X0 + min(cb + c, etw - 1);   // edge column of the tile ext
    sFY[i] = flow_at(p, k, 1, y, x);
    if (c < EW) sFX[r * EW + c] = flow_at(p, k, 0, y, x);
  }
  lkwarp::load_window(sWin, next, WR, FW, wy0 + rb, wx0 + cb, H, W);
  __syncthreads();

  // --- Scharr (exact form) and the vertical warp pass ----------------------
  for (int i = tid; i < EH * EW; i += NT) {
    const int r = i / EW, c = i % EW;
    const float* q = sP + (r + 1) * PS + (c + 1);
    const float syl = ((3.0f * q[-PS - 1] + 10.0f * q[-1]) + 3.0f * q[PS - 1]) * 0.0625f;
    const float syr = ((3.0f * q[-PS + 1] + 10.0f * q[1]) + 3.0f * q[PS + 1]) * 0.0625f;
    const float sxu = ((3.0f * q[-PS - 1] + 10.0f * q[-PS]) + 3.0f * q[-PS + 1]) * 0.0625f;
    const float sxd = ((3.0f * q[PS - 1] + 10.0f * q[PS]) + 3.0f * q[PS + 1]) * 0.0625f;
    sIX[i] = (syr - syl) * 0.5f;
    sIY[i] = (sxd - sxu) * 0.5f;
  }
  const float two_l = 2.0f * L;
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
    const float pw = sP[(r + 1) * PS + c + 1];
    sR[i] = (jw - pw) - (sIX[i] * fx + sIY[i] * fy);
  }
  __syncthreads();

  // --- five box sums: column sums in shared memory, row sums in registers --
  float acc[5][PER_T];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    for (int i = tid; i < BH * EW; i += NT) {
      const int ro = i / EW, c = i % EW;
      float s = 0.0f;
      for (int d = 1; d <= p.win_k; ++d) {
        const int e = (ro + d) * EW + c;
        float v;
        if (q == 0) v = sIX[e] * sIX[e];
        else if (q == 1) v = sIX[e] * sIY[e];
        else if (q == 2) v = sIY[e] * sIY[e];
        else if (q == 3) v = sIX[e] * sR[e];
        else v = sIY[e] * sR[e];
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

  // --- gate and 2x2 solve ---------------------------------------------------
  const float area2 = 2.0f * (float)(p.win_k * p.win_k);
#pragma unroll
  for (int m = 0; m < PER_T; ++m) {
    const int o = tid + m * NT;
    const int ro = o / BW, co = o % BW;
    if (rb + ro >= p.th || cb + co >= p.tw) continue;   // ragged tile edge
    const float a11 = acc[0][m], a12 = acc[1][m], a22 = acc[2][m];
    const float det = a11 * a22 - a12 * a12;
    const float t = a11 - a22;
    const float me = ((a11 + a22) - sqrtf(t * t + (4.0f * a12) * a12)) / area2;
    const bool solvable = det > 1e-7f;
    const float vf = (me >= p.eig_thr && solvable) ? 1.0f : 0.0f;
    const float invd = vf / (solvable ? det : 1.0f);
    const float fx = sFX[(ro + HALO) * EW + co + HALO];
    const float fy = sFY[(ro + HALO) * FW + co + HALO];
    const float b1 = (acc[3][m] + a11 * fx) + a12 * fy;
    const float b2 = (acc[4][m] + a12 * fx) + a22 * fy;
    const float du = (a12 * b2 - a22 * b1) * invd;
    const float dv = (a12 * b1 - a11 * b2) * invd;
    const size_t y = ty0 + rb + ro, x = tx0 + cb + co;
    const size_t px = y * W + x;
    p.out[((size_t)k * 2) * H * W + px] = clampf(fx + du, -D, D);
    p.out[((size_t)k * 2 + 1) * H * W + px] = clampf(fy + dv, -D, D);
    if (p.min_eig) {
      p.min_eig[(size_t)k * H * W + px] = me;
      p.valid[(size_t)k * H * W + px] = vf > 0.5f ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Launches one iteration on `stream`; returns cudaGetLastError() (0 = ok).
int lk_fused_level_launch(const void* prev, long long prev_stride,
                          const void* next, long long next_stride,
                          const void* cur, const void* init, void* out,
                          void* min_eig, void* valid, int K, int H, int W,
                          int CH, int CW, int tile_h, int tile_w, int coarse,
                          int local, int win_k, float max_disp, float eig_thr,
                          void* stream) {
  if (local < 0 || local > MAX_LOCAL || win_k < 1 || win_k > 2 * HALO - 1 ||
      K < 1 || tile_h < 1 || tile_w < 1 || H % tile_h || W % tile_w ||
      (!coarse && cur == nullptr) || ((min_eig == nullptr) != (valid == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.prev = static_cast<const float*>(prev);
  p.next = static_cast<const float*>(next);
  p.prev_stride = prev_stride;
  p.next_stride = next_stride;
  p.cur = static_cast<const float*>(cur);
  p.init = static_cast<const float*>(init);
  p.out = static_cast<float*>(out);
  p.min_eig = static_cast<float*>(min_eig);
  p.valid = static_cast<unsigned char*>(valid);
  p.H = H;
  p.W = W;
  p.CH = CH;
  p.CW = CW;
  p.th = tile_h;
  p.tw = tile_w;
  p.nbx = (tile_w + BW - 1) / BW;
  p.nby = (tile_h + BH - 1) / BH;
  p.coarse = coarse;
  p.local = local;
  p.win_k = win_k;
  p.max_disp = max_disp;
  p.eig_thr = eig_thr;
  const size_t smem = (size_t)smem_floats(local) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fused_lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W / tile_w) * p.nbx, (H / tile_h) * p.nby, K);
  fused_lk_level_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* lk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
