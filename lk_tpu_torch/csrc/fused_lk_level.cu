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
// of the edge-clamped coarse planes.  The tiled TPU kernel writes 128-aligned
// widths, so from its second iteration on the first `spill` columns right of
// the level (in its rows) carry the current flow's edge column: the wrapper
// passes spill = warp_kernels.right_spill(tile_w) there, 0 elsewhere.  All
// borders are read by clamped address.
//
// Rounding: built with --fmad=false (no FMA contraction), so every product
// rounds before it is added, as in the plain version's eager elementwise ops;
// sqrtf and '/' are IEEE (no --use_fast_math); every box sum adds its taps in
// order, down the column d = 1..win_k, then along the row (never a running
// sum).  The kernel and the plain version agree bit for bit by construction,
// and each pair's result does not depend on K or on the block shape.
//
// What bounds it on this card.  1080p level 0 (1088x2048) for a chunk of 4
// pairs is 8.9 M output pixels.  Bytes: prev, next, the coarse flow in, the
// flow, min_eig and valid out, ~23 B per pixel, ~205 MB: 0.061 ms at
// 3.35 TB/s.  Operations: 236 f32 operations per output pixel per iteration
// (five 15x15 box sums 140, gate and solve 38, warp 32, Scharr 16, residual
// and products 10); with --fmad=false each is one instruction, 2.1 G, ~0.063
// ms at ~33.5 T f32 instructions/s (132 SMs x 128 lanes x ~1.98 GHz).  The
// two floors are about equal; neither tensor cores (they would round the
// inputs to TF32) nor running sums (they would change the rounding) are open.
//
// The design, point by point against what held the first version back (one
// 32x32 block of 256 threads, 80 KB of shared memory, ~38 us of serial
// latency per block, ~20x its floors, on an NVIDIA H100 80GB HBM3 at
// 700.00 W):
//  1. Block shape from the level.  The output block is a template (BH, BW):
//     34x32 divides the 272x512 tiles of the finer 1080p levels and the
//     136x256 top, so no block row runs half idle; a block still never
//     straddles two reference tiles (a ragged last block of other tile sizes
//     writes only its tile's pixels).  17x32 blocks serve a level whose
//     34x32 grid would leave most SMs idle (the top at K = 1: 32 blocks).
//     34x64 blocks (1.8x halo, 111 KB, 2 blocks per SM) were measured
//     slower at every 1080p level (NVIDIA H100 80GB HBM3, 700.00 W) and
//     dropped.
//  2. Shared memory: Ix, Iy and the residual alias the warp window, the five
//     column-sum planes alias prev and the vertical warp pass, and coarse-in
//     levels keep the coarse patch instead of flow planes: ~70 KB for 34x32
//     (3 blocks of 272 threads per SM, 72 registers, no spills), ~50 KB for
//     17x32 (3 blocks: at 4, the register cap made its coarse-in form spill).
//  3. Asynchronous staging.  prev, the warp window of next and, on coarse-in
//     levels, the coarse patch (~(EH/2+3) x (FW/2+3) per plane) are copied
//     with cp.async, all in flight at once: rows whose columns lie inside the
//     plane 16 B at a time from the aligned column below their first
//     element, border blocks element by element by clamped address.  The
//     coarse flow is upsampled from the staged patch (4 shared-memory reads
//     per plane) where the first version made 4 global loads per element.
//     The tile reference is loaded before the staging starts, since the
//     window's origin waits on it.
//  4. Products once: each thread of the column pass walks one column of one
//     of the five products down the whole block, forms each product once and
//     adds it into the up-to-15 column sums it belongs to, in tap order (the
//     sums stay in registers, their indices fixed at compile time, as is
//     win_k = 15 on the production path); the row pass does the same along
//     the rows for all five quantities of RW outputs.  Two barriers, not ten.
//  5. local is a template parameter (0..MAX_LOCAL), as are the block shape
//     and the coarse switch, so no index arithmetic divides by a run-time
//     value.  The warp passes and Scharr run one thread per column strip,
//     walking down it: each coarse column tap, prev row and Scharr row
//     smoothing is formed once for the strip, and the strip's results are
//     stored after the walk, so its reads can run ahead.
//  6. Halo work: Scharr, both warp passes and the residual run on the
//     (BH+16) x (BW+16) extended region, 2.2x the outputs at 34x32, where
//     the first version's 48x48 region was 2.25x (3x on its half-idle ninth
//     block row).  Leaving out its first and last row and column, which no
//     box sum reads, was measured no faster and was not kept.
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, 1080p L0,
// K = 4 (chip_smoke.py phase 2): ~0.32 ms against 1.32 ms before.  chip_smoke.py --profile also times two copies
// of this file built for the measurement only (LK_FUSED_ANATOMY below): one
// whose blocks return once their staging has landed, one without the
// copies; they show whether the copies or the passes bound the kernel.
// Still open: the top level's iterations as one launch (a thread-block
// cluster holding a pair's level, halo exchange through distributed shared
// memory), and fewer instructions per output in the passes (the box sums'
// ~175 adds per output are the floor that tap order leaves).

#include <cuda_runtime.h>

// 0: the kernel.  Measurement copies only (chip_smoke.py --profile): 1, each
// block returns once its staging has landed; 2, the copies are left out and
// the passes run on whatever shared memory holds.
#ifndef LK_FUSED_ANATOMY
#define LK_FUSED_ANATOMY 0
#endif
#if LK_FUSED_ANATOMY == 2
#define LKWARP_NO_COPIES 1
#endif

#include "warp_tile.cuh"

namespace {

using lkwarp::clampf;
using lkwarp::clampi;
using lkwarp::cp_async4;
using lkwarp::cp_async_wait_all;
using lkwarp::stage;
using lkwarp::staged_stride;

constexpr int HALO = 8;
constexpr int MAX_LOCAL = 8;
constexpr int MAX_WIN = 2 * HALO - 1;  // taps of a box sum

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
  int win_k;
  int spill;               // columns right of the level read from `cur`
  float max_disp, eig_thr;
};

// Output block BH x BW; RW outputs along a row per thread of the row pass,
// so the block has BH * BW / RW threads; MINB: the blocks per SM that the
// register budget is set for (__launch_bounds__).
template <int BH_, int BW_, int RW_, int MINB_>
struct Shape {
  static constexpr int BH = BH_, BW = BW_, RW = RW_, MINB = MINB_;
  static constexpr int NT = BH * BW / RW;
  static constexpr int EH = BH + 2 * HALO, EW = BW + 2 * HALO;
  static_assert(BW % RW == 0, "RW must divide BW");
};

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory layout of one block, in floats, for local L.  Every region
// starts 16-byte aligned.
template <class S, int L, bool COARSE>
struct Layout {
  static constexpr int EH = S::EH, EW = S::EW;
  static constexpr int FW = EW + 2 * L + 1;    // columns of the vertical pass
  static constexpr int WR = EH + 2 * L + 1;    // rows of the warp window
  static constexpr int PS = staged_stride(EW + 2);   // row stride of prev
  static constexpr int WS = staged_stride(FW);       // ... of the window
  // row stride of column sums, odd: the row pass's lanes hit distinct banks
  static constexpr int SS = EW + 1;
  static constexpr int CPH = EH / 2 + 3;       // coarse patch rows
  static constexpr int CPW = FW / 2 + 3;       // coarse patch columns
  static constexpr int CS = staged_stride(CPW);      // ... its row stride
  // flow: the coarse patch (2 planes), or fx (EH x EW) and fy (EH x FW)
  static constexpr int FLOW = up4(COARSE ? 2 * CPH * CS : EH * EW + EH * FW);
  // the warp window, then Ix, Iy and the residual
  static constexpr int R1A = WR * WS, R1B = 3 * EH * EW;
  static constexpr int R1 = up4(R1A > R1B ? R1A : R1B);
  // prev and the vertical pass, then the five column-sum planes
  static constexpr int R2A = (EH + 2) * PS + EH * FW, R2B = 5 * S::BH * SS;
  static constexpr int R2 = up4(R2A > R2B ? R2A : R2B);
  static constexpr int FLOATS = FLOW + R1 + R2;
};

// upsample2_linear's x2 flow at level position (y, x) from a staged coarse
// patch (row stride CS) whose element (0, 0) holds coarse (cy0, cx0),
// edge-clamped, and whose second plane is `plane` floats on: the
// first version's flow_at, same operations in the same order.
template <int CS>
__device__ __forceinline__ void coarse_flow(const float* patch, int plane,
                                            int y, int x, int cy0, int cx0,
                                            float& fx, float& fy) {
  const int ly = (y - 1) >> 1;         // floor((y - 1) / 2), also for y < 1
  const int lx = (x - 1) >> 1;
  const float wly = (y & 1) ? 0.75f : 0.25f, why = (y & 1) ? 0.25f : 0.75f;
  const float wlx = (x & 1) ? 0.75f : 0.25f, whx = (x & 1) ? 0.25f : 0.75f;
  const int o = (ly - cy0) * CS + (lx - cx0);
  // columns first, then rows; the x2 flow scale rides on the row weights
  const float* q = patch + o;
  float t0 = wlx * q[0] + whx * q[1];
  float t1 = wlx * q[CS] + whx * q[CS + 1];
  fx = (2.0f * wly) * t0 + (2.0f * why) * t1;
  q += plane;
  t0 = wlx * q[0] + whx * q[1];
  t1 = wlx * q[CS] + whx * q[CS + 1];
  fy = (2.0f * wly) * t0 + (2.0f * why) * t1;
}

// The same upsample walking down one column x of the patch a row at a
// time: each column tap t = wlx * q[lx] + whx * q[lx + 1] of a coarse row is
// formed once and serves the two fine rows that read it (the same
// operations on the same values as coarse_flow, so the same bits).  NP
// planes from plane P0.
template <int CS, int P0, int NP>
struct CoarseColumn {
  const float* q;          // the patch at (coarse row of t0, lx), plane P0
  int plane;
  float wlx, whx, t0[NP], t1[NP];

  __device__ __forceinline__ float tap(const float* r) const {
    return wlx * r[0] + whx * r[1];
  }
  // Start at fine row y of fine column x.
  __device__ __forceinline__ void start(const float* patch, int plane_, int y,
                                        int x, int cy0, int cx0) {
    plane = plane_;
    const int ly = (y - 1) >> 1, lx = (x - 1) >> 1;
    wlx = (x & 1) ? 0.75f : 0.25f;
    whx = (x & 1) ? 0.25f : 0.75f;
    q = patch + (ly - cy0) * CS + (lx - cx0) + P0 * plane;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      t0[p] = tap(q + p * plane);
      t1[p] = tap(q + p * plane + CS);
    }
  }
  // Move down to fine row y: (y - 1) >> 1 grows by one at odd y.
  __device__ __forceinline__ void step(int y) {
    if (y & 1) {
      q += CS;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        t0[p] = t1[p];
        t1[p] = tap(q + p * plane + CS);
      }
    }
  }
  // Plane P0 + p at fine row y.
  __device__ __forceinline__ float at(int p, int y) const {
    const float wly = (y & 1) ? 0.75f : 0.25f, why = (y & 1) ? 0.25f : 0.75f;
    return (2.0f * wly) * t0[p] + (2.0f * why) * t1[p];
  }
};

// One tap of a box sum, in tap order: tap d = 1 sets the sum, taps
// 2 .. wk add to it.  WK > 0 fixes wk at compile time (the production 15),
// WK = 0 reads it at run time.
template <int WK>
__device__ __forceinline__ void tap(float& acc, float v, int d, int wk) {
  if (d == 1) acc = v;
  else if (d >= 2 && d <= MAX_WIN && (WK > 0 ? d <= WK : d <= wk))
    acc = acc + v;
}

// The column sums of one product down one column: output row o sums
// extended rows o+1 .. o+wk.  Walking j = 1 .. BH+14, the product at row j
// is formed once and added to every o it belongs to (d = j - o ascending:
// tap order); the BH sums stay in registers.  a, b: the two factors' planes
// at the column (row stride EW); s: the sums' column (row stride SS).
template <int BH, int EW, int SS, int WK>
__device__ __forceinline__ void column_sums(const float* a, const float* b,
                                            float* s, int wk) {
  float acc[BH];
#pragma unroll
  for (int j = 1; j <= BH + MAX_WIN - 1; ++j) {
    const float v = a[j * EW] * b[j * EW];
#pragma unroll
    for (int o = 0; o < BH; ++o) tap<WK>(acc[o], v, j - o, wk);
  }
#pragma unroll
  for (int o = 0; o < BH; ++o) s[o * SS] = acc[o];
}

// The row sums of all five quantities for RW consecutive outputs: output m
// sums columns m+1 .. m+wk of its row of column sums (s: the row at the
// first output's column, QS floats between the quantities' planes).
template <int RW, int QS, int WK>
__device__ __forceinline__ void row_sums(const float* s, float (&acc)[5][RW],
                                         int wk) {
#pragma unroll
  for (int q = 0; q < 5; ++q) {
#pragma unroll
    for (int j = 1; j <= RW + MAX_WIN - 1; ++j) {
      const float v = s[q * QS + j];
#pragma unroll
      for (int m = 0; m < RW; ++m) tap<WK>(acc[q][m], v, j - m, wk);
    }
  }
}

template <class S, int L, bool COARSE>
__global__ void __launch_bounds__(S::NT, S::MINB)
fused_lk_level_kernel(Params p) {
  using Y = Layout<S, L, COARSE>;
  constexpr int BH = S::BH, BW = S::BW, RW = S::RW, NT = S::NT;
  constexpr int EH = Y::EH, EW = Y::EW, FW = Y::FW, WR = Y::WR, PS = Y::PS;
  constexpr int WS = Y::WS, SS = Y::SS, CPH = Y::CPH, CPW = Y::CPW;
  constexpr int CS = Y::CS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sFlow = smem;                     // patch, or fx | fy planes
  float* sR1 = sFlow + Y::FLOW;
  float* sR2 = sR1 + Y::R1;
  float* sWin = sR1;                       // WR x WS
  float* sIX = sR1;                        // EH x EW, after the window
  float* sIY = sIX + EH * EW;
  float* sRes = sIY + EH * EW;
  float* sP = sR2;                         // (EH + 2) x PS
  float* sV = sP + (EH + 2) * PS;          // EH x FW
  float* sS = sR2;                         // 5 x BH x SS, after prev and V
  float* sFX = sFlow;                      // EH x EW (not coarse)
  float* sFY = sFlow + EH * EW;            // EH x FW (not coarse)

  const int tid = threadIdx.x;
  const int k = blockIdx.z;
  const int tj = blockIdx.x / p.nbx, bx = blockIdx.x % p.nbx;
  const int ti = blockIdx.y / p.nby, by = blockIdx.y % p.nby;
  const int H = p.H, W = p.W;
  const int ty0 = ti * p.th, tx0 = tj * p.tw;    // tile origin
  const int Y0 = ty0 - HALO, X0 = tx0 - HALO;    // tile extended origin
  const int eth = p.th + 2 * HALO, etw = p.tw + 2 * HALO;
  const int rb = by * BH, cb = bx * BW;          // block origin in the tile
  const int gy0 = Y0 + rb, gx0 = X0 + cb;        // block extended origin
  const float D = p.max_disp;
  const float* prev = p.prev + (size_t)k * p.prev_stride;
  const float* next = p.next + (size_t)k * p.next_stride;
  const size_t plane = (size_t)H * W;
  // coarse patch origin: the lower taps of the block's first row / column
  const int cy0 = (gy0 - 1) >> 1, cx0 = (gx0 - 1) >> 1;

  // --- tile reference displacement, first: the window waits on it --------
  float rfx, rfy;
  if (COARSE) {
    const int cy = clampi(ti * (p.th / 2) + (eth / 2 + 1) / 2 - 4, 0, p.CH - 1);
    const int cx = clampi(tj * (p.tw / 2) + (etw / 2 + 1) / 2 - 4, 0, p.CW - 1);
    const float* c0 = p.init + (size_t)k * 2 * p.CH * p.CW;
    rfx = 2.0f * c0[cy * p.CW + cx];
    rfy = 2.0f * c0[(size_t)p.CH * p.CW + cy * p.CW + cx];
  } else {
    const size_t at = (size_t)(Y0 + eth / 2) * W + (X0 + etw / 2);
    const float* c0 = p.cur + (size_t)k * 2 * plane;
    rfx = c0[at];
    rfy = c0[plane + at];
  }

  // --- staging: prev (+1 Scharr border) and the flow, in flight together --
  const float* sPo = sP + stage<EH + 2, EW + 2, NT>(sP, prev, gy0 - 1, gx0 - 1,
                                                   H, W);
  const float* sC = sFlow;                 // the coarse patch's (0, 0)
  if (COARSE) {
    const size_t cplane = (size_t)p.CH * p.CW;
    const float* c0 = p.init + (size_t)k * 2 * cplane;
    sC += stage<CPH, CPW, NT>(sFlow, c0, cy0, cx0, p.CH, p.CW);
    stage<CPH, CPW, NT>(sFlow + CPH * CS, c0 + cplane, cy0, cx0, p.CH, p.CW);
  } else {
    const float* cur = p.cur + (size_t)k * 2 * plane;
    const float* ini = p.init + (size_t)k * 2 * plane;
    for (int i = tid; i < EH * FW; i += NT) {
      const int r = i / FW, c = i - r * FW;
      const int y = gy0 + r;
      const int x = X0 + min(cb + c, etw - 1);   // edge column of the tile ext
      const bool in = y >= 0 && y < H && x >= 0 && x < W + p.spill;
      const size_t at = (size_t)clampi(y, 0, H - 1) * W + clampi(x, 0, W - 1);
      const float* src = in ? cur : ini;
      cp_async4(sFY + i, src + plane + at);
      if (c < EW) cp_async4(sFX + r * EW + c, src + at);
    }
  }

  // --- the warp window of next --------------------------------------------
  const int wy0 = lkwarp::window_origin(Y0, rfy, D, L);
  const int wx0 = lkwarp::window_origin(X0, rfx, D, L);
  const float* sWo = sWin + stage<WR, FW, NT>(sWin, next, wy0 + rb, wx0 + cb,
                                              H, W);
  cp_async_wait_all();
  __syncthreads();
#if LK_FUSED_ANATOMY == 1
  return;
#endif

  // --- vertical warp pass: one thread per (column, RV rows) ---------------
  // The thread walks down its column: the coarse column taps serve two rows
  // each; RV is even, so the lanes of a warp cross coarse rows together.
  // Results are stored after the walk, so its reads are free to run ahead.
  constexpr float two_l = 2.0f * L;
  constexpr int RV = 14, NSV = (EH + RV - 1) / RV;
  for (int t = tid; t < NSV * FW; t += NT) {
    const int sg = t / FW, c = t - sg * FW, r0 = sg * RV;
    CoarseColumn<CS, 1, 1> col;
    if (COARSE)
      col.start(sC, CPH * CS, gy0 + r0, X0 + min(cb + c, etw - 1), cy0, cx0);
    float v[RV];
#pragma unroll
    for (int u = 0; u < RV; ++u) {
      const int r = r0 + u;
      if (r >= EH) break;
      float fy;
      if (COARSE) {
        if (u > 0) col.step(gy0 + r);
        fy = col.at(0, gy0 + r);
      } else {
        fy = sFY[r * FW + c];
      }
      v[u] = lkwarp::tent(sWo + r * WS + c, WS, fy, rb + r, Y0, wy0, D, two_l,
                          H);
    }
#pragma unroll
    for (int u = 0; u < RV; ++u)
      if (r0 + u < EH) sV[(r0 + u) * FW + c] = v[u];
  }
  __syncthreads();

  // --- horizontal warp pass, Scharr (exact form) and the IC residual -------
  // One thread per (column, RH rows), down the column: prev's 3x3
  // neighbourhood and the row smoothing of Scharr's y derivative roll with
  // it (each row smoothed once), the coarse taps as above.
  constexpr int RH = 10, NSH = (EH + RH - 1) / RH;
  for (int t = tid; t < NSH * EW; t += NT) {
    const int sg = t / EW, c = t - sg * EW, r0 = sg * RH;
    CoarseColumn<CS, 0, 2> col;
    if (COARSE)
      col.start(sC, CPH * CS, gy0 + r0, X0 + min(cb + c, etw - 1), cy0, cx0);
    // prev at extended rows r-1, r, r+1 and columns c-1, c, c+1 (staged row
    // r of prev is extended row r - 1)
    const float* q = sPo + r0 * PS + c;
    float top0 = q[0], top2 = q[2];
    float mid0 = q[PS], mid1 = q[PS + 1], mid2 = q[PS + 2];
    float s_top = ((3.0f * top0 + 10.0f * q[1]) + 3.0f * top2) * 0.0625f;
    float s_mid = ((3.0f * mid0 + 10.0f * mid1) + 3.0f * mid2) * 0.0625f;
    float vx[RH], vy[RH], vr[RH];
#pragma unroll
    for (int u = 0; u < RH; ++u) {
      const int r = r0 + u;
      if (r >= EH) break;
      const float* b = q + (u + 2) * PS;
      const float bot0 = b[0], bot1 = b[1], bot2 = b[2];
      const float syl = ((3.0f * top0 + 10.0f * mid0) + 3.0f * bot0) * 0.0625f;
      const float syr = ((3.0f * top2 + 10.0f * mid2) + 3.0f * bot2) * 0.0625f;
      const float s_bot = ((3.0f * bot0 + 10.0f * bot1) + 3.0f * bot2) * 0.0625f;
      const float ix = (syr - syl) * 0.5f;
      const float iy = (s_bot - s_top) * 0.5f;
      float fx, fy;
      if (COARSE) {
        if (u > 0) col.step(gy0 + r);
        fx = col.at(0, gy0 + r);
        fy = col.at(1, gy0 + r);
      } else {
        fx = sFX[r * EW + c];
        fy = sFY[r * FW + c];
      }
      const float jw = lkwarp::tent(sV + r * FW + c, 1, fx, cb + c, X0, wx0,
                                    D, two_l, W);
      vx[u] = ix;
      vy[u] = iy;
      vr[u] = (jw - mid1) - (ix * fx + iy * fy);
      top0 = mid0, top2 = mid2;
      mid0 = bot0, mid1 = bot1, mid2 = bot2;
      s_top = s_mid, s_mid = s_bot;
    }
#pragma unroll
    for (int u = 0; u < RH; ++u) {
      const int i = (r0 + u) * EW + c;
      if (r0 + u < EH) {
        sIX[i] = vx[u];
        sIY[i] = vy[u];
        sRes[i] = vr[u];
      }
    }
  }
  __syncthreads();

  const int wk = p.win_k;

  // --- column sums: one thread per (product, column), down the block ------
  for (int t = tid; t < 5 * EW; t += NT) {
    const int q = t / EW, c = t - q * EW;
    const float* a = (q == 2 || q == 4) ? sIY : sIX;
    const float* b = q == 0 ? sIX : q <= 2 ? sIY : sRes;
    float* s = sS + q * BH * SS + c;
    if (wk == MAX_WIN) column_sums<BH, EW, SS, MAX_WIN>(a + c, b + c, s, wk);
    else column_sums<BH, EW, SS, 0>(a + c, b + c, s, wk);
  }
  __syncthreads();

  // --- row sums of all five quantities for RW outputs, gate and solve -----
  const float area2 = 2.0f * (float)(wk * wk);
  for (int t = tid; t < BH * (BW / RW); t += NT) {
    const int ro = t / (BW / RW), co0 = (t - ro * (BW / RW)) * RW;
    float acc[5][RW];
    const float* s = sS + ro * SS + co0;
    if (wk == MAX_WIN) row_sums<RW, BH * SS, MAX_WIN>(s, acc, wk);
    else row_sums<RW, BH * SS, 0>(s, acc, wk);
    if (rb + ro >= p.th) continue;                 // ragged tile edge
    const size_t y = ty0 + rb + ro;
#pragma unroll
    for (int m = 0; m < RW; ++m) {
      const int co = co0 + m;
      if (cb + co >= p.tw) continue;
      const float a11 = acc[0][m], a12 = acc[1][m], a22 = acc[2][m];
      const float det = a11 * a22 - a12 * a12;
      const float tr = a11 - a22;
      const float me = ((a11 + a22) - sqrtf(tr * tr + (4.0f * a12) * a12)) / area2;
      const bool solvable = det > 1e-7f;
      const float vf = (me >= p.eig_thr && solvable) ? 1.0f : 0.0f;
      const float invd = vf / (solvable ? det : 1.0f);
      float fx, fy;
      if (COARSE) {
        coarse_flow<CS>(sC, CPH * CS, gy0 + ro + HALO,
                        X0 + min(cb + co + HALO, etw - 1), cy0, cx0, fx, fy);
      } else {
        fx = sFX[(ro + HALO) * EW + co + HALO];
        fy = sFY[(ro + HALO) * FW + co + HALO];
      }
      const float b1 = (acc[3][m] + a11 * fx) + a12 * fy;
      const float b2 = (acc[4][m] + a12 * fx) + a22 * fy;
      const float du = (a12 * b2 - a22 * b1) * invd;
      const float dv = (a12 * b1 - a11 * b2) * invd;
      const size_t px = y * W + (tx0 + cb + co);
      p.out[((size_t)k * 2) * plane + px] = clampf(fx + du, -D, D);
      p.out[((size_t)k * 2 + 1) * plane + px] = clampf(fy + dv, -D, D);
      if (p.min_eig) {
        p.min_eig[(size_t)k * plane + px] = me;
        p.valid[(size_t)k * plane + px] = vf > 0.5f ? 1 : 0;
      }
    }
  }
}

// The block shapes the launcher chooses from (index = the `shape` argument).
using ShapeTall = Shape<34, 32, 4, 3>;   // 272 threads, ~70 KB coarse-in
using ShapeSmall = Shape<17, 32, 2, 3>;  // 272 threads, ~50 KB
constexpr int N_SHAPES = 2;

template <class S, int L, bool COARSE>
cudaError_t launch(const Params& p, int ntx, int nty, int K,
                   cudaStream_t stream) {
  const size_t smem = (size_t)Layout<S, L, COARSE>::FLOATS * sizeof(float);
  auto kern = fused_lk_level_kernel<S, L, COARSE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // all of the SM's unified memory as shared memory: the blocks per SM
  // come from it, and the kernel reads global memory only through cp.async
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(ntx * p.nbx, nty * p.nby, K);
  kern<<<grid, S::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class S, bool COARSE>
cudaError_t launch_local(const Params& p, int local, int ntx, int nty, int K,
                         cudaStream_t st) {
  switch (local) {
    case 0: return launch<S, 0, COARSE>(p, ntx, nty, K, st);
    case 1: return launch<S, 1, COARSE>(p, ntx, nty, K, st);
    case 2: return launch<S, 2, COARSE>(p, ntx, nty, K, st);
    case 3: return launch<S, 3, COARSE>(p, ntx, nty, K, st);
    case 4: return launch<S, 4, COARSE>(p, ntx, nty, K, st);
    case 5: return launch<S, 5, COARSE>(p, ntx, nty, K, st);
    case 6: return launch<S, 6, COARSE>(p, ntx, nty, K, st);
    case 7: return launch<S, 7, COARSE>(p, ntx, nty, K, st);
    default: return launch<S, 8, COARSE>(p, ntx, nty, K, st);
  }
  static_assert(MAX_LOCAL == 8, "extend the dispatch");
}

template <class S>
cudaError_t launch_shape(Params& p, int coarse, int local, int K,
                         cudaStream_t st) {
  p.nbx = (p.tw + S::BW - 1) / S::BW;
  p.nby = (p.th + S::BH - 1) / S::BH;
  const int ntx = p.W / p.tw, nty = p.H / p.th;
  return coarse ? launch_local<S, true>(p, local, ntx, nty, K, st)
                : launch_local<S, false>(p, local, ntx, nty, K, st);
}

template <class S>
long long blocks_of(const Params& p, int K) {
  return (long long)K * (p.H / p.th) * (p.W / p.tw)
         * ((p.th + S::BH - 1) / S::BH) * ((p.tw + S::BW - 1) / S::BW);
}

// The block shape for a level: 34x32 unless it leaves more than half of
// the 132 SMs without a block (the 1080p top level at K = 1: 32 blocks),
// where 17x32 blocks halve each block's serial work.
int pick_shape(const Params& p, int K) {
  return blocks_of<ShapeTall>(p, K) >= 132 / 2 ? 0 : 1;
}

}  // namespace

extern "C" {

// Launches one iteration on `stream`; returns cudaGetLastError() (0 = ok).
// spill: the right-halo columns read from `cur` (0..HALO; 0 on coarse-in
// levels).  shape: the block shape (0: 34x32, 1: 17x32), or -1 to let the
// launcher choose from the level's size.  Every shape gives the same bits.
int lk_fused_level_launch(const void* prev, long long prev_stride,
                          const void* next, long long next_stride,
                          const void* cur, const void* init, void* out,
                          void* min_eig, void* valid, int K, int H, int W,
                          int CH, int CW, int tile_h, int tile_w, int coarse,
                          int local, int win_k, int spill, float max_disp,
                          float eig_thr, int shape, void* stream) {
  if (local < 0 || local > MAX_LOCAL || win_k < 1 || win_k > MAX_WIN ||
      K < 1 || tile_h < 1 || tile_w < 1 || H % tile_h || W % tile_w ||
      spill < 0 || spill > HALO || (coarse && spill) ||
      shape < -1 || shape >= N_SHAPES ||
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
  p.win_k = win_k;
  p.spill = spill;
  p.max_disp = max_disp;
  p.eig_thr = eig_thr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (shape < 0 ? pick_shape(p, K) : shape) {
    case 0: return (int)launch_shape<ShapeTall>(p, coarse, local, K, st);
    default: return (int)launch_shape<ShapeSmall>(p, coarse, local, K, st);
  }
}

const char* lk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
