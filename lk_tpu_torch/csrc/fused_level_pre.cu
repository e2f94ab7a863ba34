// fused_level_pre.cu — the inverse-compositional dense Lucas–Kanade
// iterations of a pyramid level on precomputed gradients and structure
// tensor, on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lk_tpu/flow/pallas_kernels.py
// make_fused_lk_level (_fused_level_kernel): the fused level of
// fused_grads_in_kernel=False, whose prologue (Scharr, the three box sums of
// A, the min-eig gate and inv_det) runs outside the kernel.  The plain
// PyTorch version is lk_tpu_torch/flow/warp_kernels.py
// fused_lk_level_precomputed_reference.  All n_iters iterations run in one
// launch, as in the TPU kernel's (n_iters, tiles_y, tiles_x) grid, Jacobi
// across tiles over two ping-pong flow buffers.
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
// Iteration 1 reads the initial flow as the current one.
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
// and clip 6), ~0.34 us at 67 TFLOP/s.  At that size the time is latency:
// each iteration is a chain of dependent phases (loads, the two warp
// passes, the residual, the two box sums, the solve) and a grid-wide
// barrier, so the design keeps that chain short and pays one launch.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of as many
// blocks as fit on the card at once, or fewer when there are fewer regions.
// A region is one (BH, BW) output block of a reference tile; every
// intermediate of a region (flow, warp, residual, column sums) stays in
// shared memory.  Per iteration the blocks walk the regions in a grid-stride
// loop, and a grid barrier (cooperative_groups::this_grid().sync())
// separates an iteration from the next, which reads its flow: those reads go
// through L2 only (__ldcg), never the non-coherent read-only path.  When
// the grid holds every region, a block keeps its region for the whole call:
// it stages prev / ix / iy over the extended region and A / inv_det under
// its outputs once, and reloads only the flow and the warp window per
// iteration.  The box sums' tap loops are unrolled to the 15 taps the halo
// allows, so their shared-memory loads overlap.  Block shapes (same bits):
// 16x32 outputs with 512 threads where every region gets a block of its
// own (the 1080p top: 72 regions), else 32x32 with 512 threads, which
// restage less halo per output (a tiled 576x1024 level: 576 regions);
// 16x16 blocks of 256 threads were slower at both.  Each iteration is a
// latency chain (a dependent flow load for the window
// origin, the loads, six block barriers, the grid barrier): more threads
// per region shorten it; blocks with their loads batched in registers or
// their indices stepped without divisions were no faster on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using lkwarp::clampf;
using lkwarp::clampi;

constexpr int HALO = 8;
constexpr int MAX_LOCAL = 8;
constexpr int MAX_WIN = 2 * HALO - 1;  // box-sum taps the halo allows
constexpr int N_SHAPES = 2;            // (BH, BW, threads), see SHAPES

struct Params {
  const float* next;       // (H, W) planes, row-major
  const float* prev;
  const float* ix;
  const float* iy;
  const float* a11;
  const float* a12;
  const float* a22;
  const float* inv_det;
  const float* init;       // (2, H, W) initial flow; never written
  float* buf[2];           // (2, H, W); iteration i writes buf[i % 2]
  int H, W;
  int th, tw;              // reference tile
  int nbx, nby;            // blocks per tile along x / y
  int regions;             // blocks of all tiles
  int local, win_k, spill, n_iters;
  float max_disp;
};

// Flow component c at level position (y, x), which may lie outside the level:
// `cur` inside the level (and the first `spill` columns right of it), the
// initial flow edge-replicated elsewhere.  `cur` was written by other blocks
// before the grid barrier: read through L2.
__device__ __forceinline__ float flow_at(const Params& p, const float* cur,
                                         int spill, int c, int y, int x) {
  const size_t plane = (size_t)c * p.H * p.W;
  if (y >= 0 && y < p.H && x >= 0 && x < p.W + spill)
    return __ldcg(cur + plane + (size_t)y * p.W + min(x, p.W - 1));
  return __ldg(p.init + plane + (size_t)clampi(y, 0, p.H - 1) * p.W
               + clampi(x, 0, p.W - 1));
}

__host__ __device__ constexpr int smem_floats(int bh, int bw, int local) {
  const int eh = bh + 2 * HALO, ew = bw + 2 * HALO;
  const int fw = ew + 2 * local + 1;   // columns of the vertical warp pass
  const int wr = eh + 2 * local + 1;   // rows of the warp window
  const int warp = wr * fw, sums = bh * ew;
  return 4 * eh * ew + eh * fw + eh * ew + eh * fw
         + (warp > sums ? warp : sums);
}

// One iteration of one region.  `stage`: load prev / ix / iy into shared
// memory and A / inv_det into `A` (else both hold this region's already).
template <int BH, int BW, int NT>
__device__ __forceinline__ void region_step(
    const Params& p, float* smem, int region, const float* cur, float* out,
    int spill, bool stage, float (&A)[4][BH * BW / NT]) {
  constexpr int EH = BH + 2 * HALO;
  constexpr int EW = BW + 2 * HALO;
  constexpr int PER_T = BH * BW / NT;  // output pixels per thread
  static_assert(PER_T * NT == BH * BW, "whole output pixels per thread");
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
  const int bxs = (p.W / p.tw) * p.nbx;    // regions per row of regions
  const int gx = region % bxs, gy = region / bxs;
  const int tj = gx / p.nbx, bx = gx % p.nbx;
  const int ti = gy / p.nby, by = gy % p.nby;
  const int H = p.H, W = p.W;
  const int ty0 = ti * p.th, tx0 = tj * p.tw;    // tile origin
  const int Y0 = ty0 - HALO, X0 = tx0 - HALO;    // tile extended origin
  const int eth = p.th + 2 * HALO, etw = p.tw + 2 * HALO;
  const int rb = by * BH, cb = bx * BW;          // block origin in the tile
  const float D = p.max_disp;
  const float two_l = 2.0f * L;

  __syncthreads();                 // the previous region's reads are done

  // --- reference displacement: the current flow at the region centre -------
  const size_t at = (size_t)(Y0 + eth / 2) * W + (X0 + etw / 2);
  const int wy0 = lkwarp::window_origin(Y0, __ldcg(cur + (size_t)H * W + at),
                                        D, L);
  const int wx0 = lkwarp::window_origin(X0, __ldcg(cur + at), D, L);

  // --- loads: prev / ix / iy (once per region), flow, warp window ---------
  if (stage) {
    for (int i = tid; i < EH * EW; i += NT) {
      const int r = i / EW, c = i % EW;
      const size_t q = (size_t)clampi(Y0 + rb + r, 0, H - 1) * W
                       + clampi(X0 + cb + c, 0, W - 1);
      sP[i] = __ldg(p.prev + q);
      sIX[i] = __ldg(p.ix + q);
      sIY[i] = __ldg(p.iy + q);
    }
  }
  for (int i = tid; i < EH * FW; i += NT) {
    const int r = i / FW, c = i % FW;
    const int y = Y0 + rb + r;
    const int x = X0 + min(cb + c, etw - 1);   // edge column of the tile ext
    sFY[i] = flow_at(p, cur, spill, 1, y, x);
    if (c < EW) sFX[r * EW + c] = flow_at(p, cur, spill, 0, y, x);
  }
  lkwarp::load_window(sWin, p.next, WR, FW, wy0 + rb, wx0 + cb, H, W);
  __syncthreads();

  // --- vertical warp pass ---------------------------------------------------
  for (int i = tid; i < EH * FW; i += NT) {
    const int r = i / FW, c = i % FW;
    sV[i] = lkwarp::tent(sWin + i, FW, sFY[i], rb + r, Y0, wy0, D, two_l, H);
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
#pragma unroll
      for (int d = 1; d <= MAX_WIN; ++d) {   // unrolled: the loads overlap
        const int e = (ro + d) * EW + c;
        const float v = g[e] * sR[e];
        if (d <= p.win_k) s = (d == 1) ? v : s + v;
      }
      sS[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER_T; ++m) {
      const int o = tid + m * NT;
      const float* row = sS + (o / BW) * EW + (o % BW);
      float s = row[1];
#pragma unroll
      for (int d = 2; d <= MAX_WIN; ++d)
        if (d <= p.win_k) s = s + row[d];
      acc[q][m] = s;
    }
    __syncthreads();
  }

  // --- A v correction and the 2x2 solve -------------------------------------
#pragma unroll
  for (int m = 0; m < PER_T; ++m) {
    const int o = tid + m * NT;
    const int ro = o / BW, co = o % BW;
    if (rb + ro >= p.th || cb + co >= p.tw) continue;   // ragged tile edge
    const size_t px = (size_t)(ty0 + rb + ro) * W + (tx0 + cb + co);
    if (stage) {
      A[0][m] = __ldg(p.a11 + px);
      A[1][m] = __ldg(p.a12 + px);
      A[2][m] = __ldg(p.a22 + px);
      A[3][m] = __ldg(p.inv_det + px);
    }
    const float a11 = A[0][m], a12 = A[1][m], a22 = A[2][m];
    const float invd = A[3][m];
    const float fx = sFX[(ro + HALO) * EW + co + HALO];
    const float fy = sFY[(ro + HALO) * FW + co + HALO];
    const float b1 = (acc[0][m] + a11 * fx) + a12 * fy;
    const float b2 = (acc[1][m] + a12 * fx) + a22 * fy;
    const float du = (a12 * b2 - a22 * b1) * invd;
    const float dv = (a12 * b1 - a11 * b2) * invd;
    out[px] = clampf(fx + du, -D, D);
    out[(size_t)H * W + px] = clampf(fy + dv, -D, D);
  }
}

template <int BH, int BW, int NT>
__global__ void __launch_bounds__(NT)
fused_level_pre_kernel(Params p) {
  extern __shared__ float smem[];
  // Every region has a block of its own: keep it, and its staged planes,
  // for the whole call.
  const bool own = p.regions <= (int)gridDim.x;
  float A[4][BH * BW / NT];
  for (int it = 0; it < p.n_iters; ++it) {
    if (it > 0) cg::this_grid().sync();    // iteration it-1's flow written
    const float* cur = it == 0 ? p.init : p.buf[(it - 1) & 1];
    float* out = p.buf[it & 1];
    const int spill = it == 0 ? 0 : p.spill;
    for (int r = blockIdx.x; r < p.regions; r += gridDim.x)
      region_step<BH, BW, NT>(p, smem, r, cur, out, spill, it == 0 || !own,
                              A);
  }
}

struct Shape {
  int bh, bw, nt;
  const void* fn;
};

template <int BH, int BW, int NT>
Shape shape_of() {
  return {BH, BW, NT,
          reinterpret_cast<const void*>(fused_level_pre_kernel<BH, BW, NT>)};
}

// Output rows, columns and threads of a block; the kernel instance.
const Shape SHAPES[N_SHAPES] = {
    shape_of<32, 32, 512>(),
    shape_of<16, 32, 512>(),
};

// Blocks of SHAPES[s] at `local` that fit on an SM of the current device
// and its SM count (cached per device; the launch is on the host's hot
// path).  The first query per device and shape also lifts the shape's
// dynamic shared memory limit to its MAX_LOCAL size.
cudaError_t resident_blocks(int s, int local, int* per_sm, int* sms) {
  static int cache[64][N_SHAPES][MAX_LOCAL + 1];
  static int sm_count[64];
  static bool lifted[64][N_SHAPES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev][s][local] > 0) {
    *per_sm = cache[dev][s][local];
    *sms = sm_count[dev];
    return cudaSuccess;
  }
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const Shape& sh = SHAPES[s];
  if (dev >= 64 || !lifted[dev][s]) {
    e = cudaFuncSetAttribute(
        sh.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(sh.bh, sh.bw, MAX_LOCAL) * sizeof(float)));
    if (e != cudaSuccess) return e;
    if (dev < 64) lifted[dev][s] = true;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, sh.fn, sh.nt, smem_floats(sh.bh, sh.bw, local) * sizeof(float));
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorLaunchOutOfResources;
  if (dev < 64) {
    cache[dev][s][local] = *per_sm;
    sm_count[dev] = *sms;
  }
  return cudaSuccess;
}

int regions_of(const Shape& sh, int H, int W, int th, int tw) {
  return (H / th) * ((th + sh.bh - 1) / sh.bh) * (W / tw)
         * ((tw + sh.bw - 1) / sh.bw);
}

}  // namespace

extern "C" {

// Launches the n_iters iterations of one level on `stream`; returns a CUDA
// error code (0 = ok).  All planes row-major (H, W); init, buf0 and buf1
// (2, H, W): iteration i (from 0) writes buf[i % 2], so the result is in
// buf[(n_iters - 1) % 2]; buf1 may be null when n_iters == 1; init is read
// only and must be neither buffer.  spill: the right-halo refresh of the
// iterations after the first.  shape: SHAPES index, or -1 for the default.
// blocks_per_sm caps the grid below the resident maximum (0: no cap).  A
// grid that cannot be co-resident is an error, never a smaller launch.
int lk_fused_level_pre_launch(const void* next, const void* prev,
                              const void* ix, const void* iy, const void* a11,
                              const void* a12, const void* a22,
                              const void* inv_det, const void* init,
                              void* buf0, void* buf1, int H, int W,
                              int tile_h, int tile_w, int local, int win_k,
                              int spill, int n_iters, float max_disp,
                              int shape, int blocks_per_sm, void* stream) {
  if (local < 0 || local > MAX_LOCAL || win_k < 1 || win_k > MAX_WIN ||
      tile_h < 1 || tile_w < 1 || H % tile_h || W % tile_w || spill < 0 ||
      spill > HALO || n_iters < 1 || shape < -1 || shape >= N_SHAPES ||
      blocks_per_sm < 0 || buf0 == nullptr || init == buf0 ||
      (n_iters > 1 && (buf1 == nullptr || buf1 == buf0 || init == buf1)))
    return (int)cudaErrorInvalidValue;
  // default: 16x32 blocks where each region gets a block of its own (the
  // 1080p top level), else 32x32 blocks, which restage less halo
  int s = shape;
  if (s < 0) {
    int per_sm = 0, sms = 0;
    const cudaError_t e = resident_blocks(1, local, &per_sm, &sms);
    if (e != cudaSuccess) return (int)e;
    s = regions_of(SHAPES[1], H, W, tile_h, tile_w) <= per_sm * sms ? 1 : 0;
  }
  const Shape& sh = SHAPES[s];
  Params p;
  p.next = static_cast<const float*>(next);
  p.prev = static_cast<const float*>(prev);
  p.ix = static_cast<const float*>(ix);
  p.iy = static_cast<const float*>(iy);
  p.a11 = static_cast<const float*>(a11);
  p.a12 = static_cast<const float*>(a12);
  p.a22 = static_cast<const float*>(a22);
  p.inv_det = static_cast<const float*>(inv_det);
  p.init = static_cast<const float*>(init);
  p.buf[0] = static_cast<float*>(buf0);
  p.buf[1] = static_cast<float*>(buf1);
  p.H = H;
  p.W = W;
  p.th = tile_h;
  p.tw = tile_w;
  p.nbx = (tile_w + sh.bw - 1) / sh.bw;
  p.nby = (tile_h + sh.bh - 1) / sh.bh;
  p.regions = regions_of(sh, H, W, tile_h, tile_w);
  p.local = local;
  p.win_k = win_k;
  p.spill = spill;
  p.n_iters = n_iters;
  p.max_disp = max_disp;
  int per_sm = 0, sms = 0;
  cudaError_t e = resident_blocks(s, local, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (blocks_per_sm > 0 && blocks_per_sm < per_sm) per_sm = blocks_per_sm;
  const int all = per_sm * sms;
  const int blocks = p.regions < all ? p.regions : all;
  const size_t smem = (size_t)smem_floats(sh.bh, sh.bw, local) * sizeof(float);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(sh.fn, dim3(blocks), dim3(sh.nt), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
