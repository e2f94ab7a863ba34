// pyr_down.cu — the pyramid build of N same-shape f32 planes in one launch,
// on NVIDIA Hopper (sm_90a): the base edge-replicated from (H, W) out to
// (PH, PW), then `levels` cv.pyrDown steps, each the 5-tap [1,4,6,4,1]/16
// filter on both axes with BORDER_REFLECT_101, even-pixel decimation and
// (ceil(h/2), ceil(w/2)) out.  One level with no pad is pyrDown alone.
//
// Replaces the Pallas TPU kernel lk_tpu/flow/pallas_kernels.py
// _pallas_pyr_down (_pyr_down_kernel; pallas_pyr_down_pair and
// pallas_pyr_down_one are its N = 2 and N = 1 forms), together with the
// jnp.pad(mode="edge") of the base in lk_tpu/flow/dense.py
// build_frame_levels.  The TPU kernel's column pass is a bf16 band matmul;
// this kernel is held bit for bit to the port's exact f32 plain version
// instead, lk_tpu_torch/ops/blur.py build_pyramid_reference: the edge pad,
// then per level rows filtered and decimated first, then columns, each
// output ((((x0*t0 + x1*t1) + x2*t2) + x3*t3) + x4*t4) with every product
// rounded (built with --fmad=false).
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of as many
// blocks as fit on the card at once.  Level by level, the blocks walk the
// level's (TH, TW) output tiles of every plane in a grid-stride loop, and a
// grid-wide barrier (cooperative_groups::this_grid().sync()) separates a
// level from the next, which reads it (from L2: a 5-frame 1080p chunk's
// first level is 11 MB against the card's 50 MB).  A tile stages the
// (2TH+3, 2TW+8) input rows and columns its outputs read, the vertical pass
// writes every staged column's two-row sums into shared memory, the
// horizontal pass reads them to the outputs.  Borders are addresses:
// padded row i of the first level reads stored row
// min(reflect101(i, PH), H-1) — "edge pad to (PH, PW), then REFLECT_101 on
// the padded extent", including the plain version's n == 1 clamp — so no
// padded copy is read.  The first level's tiles also write the padded
// base: each owns the 2TH x 2TW base pixels under its outputs, taken from
// its staged rows, so each base pixel is read once and written once.
// A block stages its next tile with cp.async while it computes the
// current one (two staging buffers); staged rows that lie inside the
// stored width copy 16 bytes at a time from the aligned column 4 left of
// the tile's first tap, the others 4 bytes at a time by clamped address.
// Three blocks of 256 threads fit on an SM (74 registers a thread); a
// form held to 64 registers, four blocks an SM, was slower at the 1080p
// shapes.
//
// What bounds it on this card: the compulsory traffic.  A 5-frame 1080p
// chunk padded to 1088x2048 with 3 levels reads 41.5 MB and writes 59.2 MB
// (30.0 us at 3.35 TB/s) against 6.75 f32 operations per input pixel of
// each level (3.3 us at 67 TFLOP/s).  A tile reads its 3-row and 8-column
// halo again, 1.2x its share, from L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 16;                 // output rows per tile
constexpr int TW = 64;                 // output cols per tile
constexpr int IH = 2 * TH + 3;         // staged input rows
constexpr int SW = 2 * TW + 8;         // staged input cols, 4 left of the
                                       // first tap: a multiple of 4 floats
constexpr int VW = 2 * TW + 3;         // vertical-pass cols
constexpr int NT = 256;                // threads per block
constexpr int MAX_LEVELS = 16;
constexpr float T0 = 1.0f / 16.0f, T1 = 4.0f / 16.0f, T2 = 6.0f / 16.0f;

struct Level {
  const float* src;  // (n, sh, sw) planes this level decimates
  float* dst;        // (n, oh, ow)
  int sh, sw;        // stored extent of src
  int ph, pw;        // extent src is reflected on (>= stored: the pad)
  int oh, ow;        // (ceil(ph/2), ceil(pw/2))
  int tx, ty;        // tiles per output row, per output column
  int vec;           // src rows load 16 bytes at a time (sw % 4 == 0,
                     // src 16-byte aligned)
};

struct Params {
  int n, levels;
  float* base;       // (n, ph, pw) padded base of level 0, or null
  int base_vec;      // base rows store 16 bytes at a time
  Level lv[MAX_LEVELS];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);        // n == 1 has no reflection partner
}

// stored index of padded index i: REFLECT_101 on the padded extent p, then
// the edge pad's clamp into the s stored
__device__ __forceinline__ int src_index(int i, int p, int s) {
  return min(reflect101(i, p), s - 1);
}

__device__ __forceinline__ float taps5(const float* v, int stride) {
  float a = v[0] * T0;
  a = a + v[stride] * T1;
  a = a + v[2 * stride] * T2;
  a = a + v[3 * stride] * T1;
  return a + v[4 * stride] * T0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Tile {
  int plane, oy0, ox0;
};

__device__ __forceinline__ Tile tile_at(const Level& L, int t) {
  const int per_plane = L.tx * L.ty;
  const int plane = t / per_plane;
  const int r = t - plane * per_plane;
  return {plane, (r / L.tx) * TH, (r % L.tx) * TW};
}

// Start the copies of tile t's staged input (padded rows from 2*oy0 - 2,
// columns from 2*ox0 - 4) into `in`.  Later levels read what this launch
// wrote before the last grid barrier: 16-byte copies go through L2 only
// (.cg); 4-byte ones (.ca) may fill L1, which holds no line of a level
// from before its writes (no SM reads a level before the barrier after
// them).
__device__ __forceinline__ void stage(const Level& L, int t,
                                      float (*in)[SW]) {
  const Tile T = tile_at(L, t);
  const int y0 = 2 * T.oy0 - 2;
  const int x0 = 2 * T.ox0 - 4;
  const float* src = L.src + (size_t)T.plane * L.sh * L.sw;
  if (L.vec && x0 >= 0 && x0 + SW <= L.sw) {
    // every staged column is stored: the pad and the reflection touch rows
    for (int i = threadIdx.x; i < IH * (SW / 4); i += NT) {
      const int rr = i / (SW / 4);
      const int c4 = i - rr * (SW / 4);
      const int sy = src_index(y0 + rr, L.ph, L.sh);
      cp_async16(&in[rr][4 * c4], src + (size_t)sy * L.sw + x0 + 4 * c4);
    }
  } else {
    for (int i = threadIdx.x; i < IH * SW; i += NT) {
      const int rr = i / SW;
      const int c = i - rr * SW;
      cp_async4(&in[rr][c], src + (size_t)src_index(y0 + rr, L.ph, L.sh)
                                      * L.sw
                                + src_index(x0 + c, L.pw, L.sw));
    }
  }
}

// Tile t from its staged input: the vertical pass (and on the first level
// the padded base under the tile), then the horizontal pass.
__device__ __forceinline__ void compute(const Params& P, const Level& L,
                                        int t, bool first,
                                        const float (*in)[SW],
                                        float (*vt)[VW]) {
  const Tile T = tile_at(L, t);
  for (int i = threadIdx.x; i < TH * VW; i += NT) {
    const int rr = i / VW;
    const int c = i - rr * VW;
    vt[rr][c] = taps5(&in[2 * rr][c + 2], SW);
  }
  if (first && P.base != nullptr) {
    // padded (y, x) is staged at in[y - 2*oy0 + 2][x - 2*ox0 + 4]
    float* dst = P.base + (size_t)T.plane * L.ph * L.pw;
    const int by0 = 2 * T.oy0, bx0 = 2 * T.ox0;
    if (P.base_vec && bx0 + 2 * TW <= L.pw) {
      for (int i = threadIdx.x; i < 2 * TH * (2 * TW / 4); i += NT) {
        const int rr = i / (2 * TW / 4);
        const int c4 = i - rr * (2 * TW / 4);
        if (by0 + rr < L.ph)
          *reinterpret_cast<float4*>(dst + (size_t)(by0 + rr) * L.pw + bx0
                                     + 4 * c4) =
              *reinterpret_cast<const float4*>(&in[rr + 2][4 * c4 + 4]);
      }
    } else {
      for (int i = threadIdx.x; i < 2 * TH * 2 * TW; i += NT) {
        const int rr = i / (2 * TW);
        const int c = i - rr * (2 * TW);
        if (by0 + rr < L.ph && bx0 + c < L.pw)
          dst[(size_t)(by0 + rr) * L.pw + bx0 + c] = in[rr + 2][c + 4];
      }
    }
  }
  __syncthreads();
  float* dst = L.dst + (size_t)T.plane * L.oh * L.ow;
  for (int i = threadIdx.x; i < TH * TW; i += NT) {
    const int rr = i / TW;
    const int c = i - rr * TW;
    const int oy = T.oy0 + rr;
    const int ox = T.ox0 + c;
    if (oy < L.oh && ox < L.ow)
      dst[(size_t)oy * L.ow + ox] = taps5(&vt[rr][2 * c], 1);
  }
}

__global__ void __launch_bounds__(NT)
pyramid_kernel(const __grid_constant__ Params P) {
  // two staging buffers: tile t + gridDim.x lands while tile t computes
  __shared__ __align__(16) float in[2][IH][SW];
  __shared__ float vt[TH][VW];
  for (int l = 0; l < P.levels; ++l) {
    if (l > 0) cg::this_grid().sync();
    const Level& L = P.lv[l];
    const int tiles = P.n * L.tx * L.ty;
    int b = 0;
    if ((int)blockIdx.x < tiles) stage(L, blockIdx.x, in[0]);
    cp_async_commit();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      // in[b ^ 1] was last read before the previous tile's mid barrier
      if (t + (int)gridDim.x < tiles) stage(L, t + gridDim.x, in[b ^ 1]);
      cp_async_commit();
      cp_async_wait_but_newest();
      __syncthreads();                 // tile t staged; vt free
      compute(P, L, t, l == 0, in[b], vt);
      b ^= 1;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks of pyramid_kernel that fit on the current device at once, per SM
// and in all (cached per device: the launch is on the host's hot path).
cudaError_t resident_blocks(int* per_sm, int* sms) {
  static int cache[64][2];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev][0] > 0) {
    *per_sm = cache[dev][0];
    *sms = cache[dev][1];
    return cudaSuccess;
  }
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pyramid_kernel,
                                                    NT, 0);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorLaunchOutOfResources;
  if (dev < 64) {
    cache[dev][0] = *per_sm;
    cache[dev][1] = *sms;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches one pyramid build over n contiguous (H, W) planes x on
// `stream`: base (n, PH, PW) gets x edge-replicated (null: not written),
// outs[l] (n, ceil(h_l/2), ceil(w_l/2)) level l + 1, h_0 = PH, w_0 = PW.
// blocks_per_sm caps the grid below the resident maximum (0: no cap).
// Returns a CUDA error code (0 = ok); a grid that cannot be co-resident is
// an error, never a smaller launch.
int lk_pyramid_launch(const void* x, void* base, void* const* outs, int n,
                      int H, int W, int PH, int PW, int levels,
                      int blocks_per_sm, void* stream) {
  if (n < 1 || H < 1 || W < 1 || PH < H || PW < W || levels < 1 ||
      levels > MAX_LEVELS || blocks_per_sm < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.n = n;
  p.levels = levels;
  p.base = static_cast<float*>(base);
  p.base_vec = base != nullptr && PW % 4 == 0 && aligned16(base);
  const float* src = static_cast<const float*>(x);
  int sh = H, sw = W, ph = PH, pw = PW;
  long long most = 0;
  for (int l = 0; l < levels; ++l) {
    Level& L = p.lv[l];
    L.src = src;
    L.dst = static_cast<float*>(outs[l]);
    L.sh = sh;
    L.sw = sw;
    L.ph = ph;
    L.pw = pw;
    L.oh = (ph + 1) / 2;
    L.ow = (pw + 1) / 2;
    L.tx = (L.ow + TW - 1) / TW;
    L.ty = (L.oh + TH - 1) / TH;
    L.vec = sw % 4 == 0 && aligned16(src);
    const long long tiles = (long long)n * L.tx * L.ty;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    most = tiles > most ? tiles : most;
    src = L.dst;
    sh = ph = L.oh;
    sw = pw = L.ow;
  }
  int per_sm = 0, sms = 0;
  cudaError_t e = resident_blocks(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (blocks_per_sm > 0 && blocks_per_sm < per_sm) per_sm = blocks_per_sm;
  const long long all = (long long)per_sm * sms;
  const int blocks = (int)(most < all ? most : all);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pyramid_kernel),
                                  dim3(blocks), dim3(NT), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
