// vp_scan.cu — the cross-point / VP-update scan of one frame for B streams on
// NVIDIA Hopper (sm_90a): the VP state machine's per-pair loop, one launch
// per frame.
//
// Replaces no TPU kernel.  lk_tpu runs this scan as a lax.while_loop
// (lk_tpu/geometry/vanishing.py process_frame_pairs); the port's plain
// version, lk_tpu_torch/geometry/vanishing.py process_frame_pairs_reference,
// is a Python loop of about 90 tensor operations per pair step, each a
// launch on the card: 17,000 launches a frame when a CUDA graph scans all
// C(20, 2) = 190 pairs of 64 streams.  This kernel takes their place.
//
// What bounds it on this card: latency.  The work is a dependent chain of
// at most n_cand steps per stream (a VP update reads the ring that the step
// before it wrote), each about 300 f32 operations over the 15-slot CP ring;
// the bytes are about 0.65 MB at B = 64, P = 190 (the 300-slot history ring
// copied, the candidates read, the output rows written): 0.2 us at
// 3.35 TB/s.  Design: one warp per stream, one block per warp, so each
// stream's chain runs on its own SM.  The warp's lanes copy the history
// ring, stage the stream's candidates in shared memory and zero every
// output slot that no step writes; lane 0 then walks the stream's own
// candidates, up to its last one (not the batch's longest), with the whole
// carry in registers: VP, the CP ring (a template bound of 16 or 64 slots,
// unrolled, so the ring never leaves registers), its totals, the alias.
//
// Rounding: built with --fmad=false and IEEE sqrtf and division, and every
// operation in the plain version's order, so the result is bit-equal to
// the plain version run on the card.  The plain version's four ring sums
// (mean, variance, kept mean, init mean) are torch reductions over the ring
// axis, which PyTorch's CUDA reduce (ReduceOp, vt0 = 4, one thread per
// output) takes in four accumulators started at 0, slot k added to
// accumulator k % 4 in slot order, then ((a0 + a1) + a2) + a3; Sum4 below
// takes that order.  Masked terms are multiplied by 0 or 1, as the plain
// version multiplies them, and not skipped.

#include <cuda_runtime.h>

#include <cstdint>

// The launch's arguments, field for field as lk_tpu_torch/geometry/
// vanishing.py _ScanArgs declares them.  The input state and candidates are
// only read; the new state and the outputs are written whole.
struct LkVpScanArgs {
  // VPState in: (B, 2), (B,), (B,), (B, R, 2), (B,) x 3, (B, H, 2), (B,)
  const float* vp_xy;
  const uint8_t* vp_init;
  const uint8_t* vp_moved;
  const float* ring_xy;
  const int64_t* ring_total;
  const int64_t* alias_pos;
  const int64_t* vp_ult;
  const float* hist_xy;
  const int64_t* hist_total;
  // VPState out, the same shapes
  float* o_vp_xy;
  uint8_t* o_vp_init;
  uint8_t* o_vp_moved;
  float* o_ring_xy;
  int64_t* o_ring_total;
  int64_t* o_alias_pos;
  int64_t* o_vp_ult;
  float* o_hist_xy;
  int64_t* o_hist_total;
  // the frame's cross points (B, P, 2), candidates first, and (B, P) flags
  const float* cps;
  const uint8_t* cand;
  // FrameGeomOut: (B, P, 2), (B, P), (B, P, 2), (B, P), (B, 2), (B,), (B,)
  float* update_rows;
  uint8_t* update_mask;
  float* cp_xy;
  uint8_t* cp_mask;
  float* show_row;
  uint8_t* show_mask;
  uint8_t* vp_hidden;
  int B, P;
  int R;          // CP ring slots (vp_ref_num)
  int H;          // history ring slots (vp_ref)
  int aliasing;   // vp_init_aliasing
  float bound_x, bound_y;   // width * cp_thold, height * cp_thold
  float rate, clip, r_cap;  // vp_update_rate, max_cp_std, float(R)
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;       // opt-in shared memory of a block

// torch's CUDA sum over the ring axis, in its order (see the header).
struct Sum4 {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void add(int k, float v) {
    a[k & 3] = a[k & 3] + v;
  }
  __device__ __forceinline__ float total() const {
    return ((a[0] + a[1]) + a[2]) + a[3];
  }
};

// Python's x % m for m > 0 (torch.remainder).
__device__ __forceinline__ int pymod(long long x, int m) {
  const long long r = x % m;
  return (int)(r < 0 ? r + m : r);
}

// The update branch of one accepted step of an initialized stream: the
// plain version's masked mean +- std * clip keep over the ring, the kept
// mean times the rate.  t is the ring total after the append, alias the
// aliased append index (-1: none).  Moves (vx, vy) and returns true when
// the VP updates.
template <int MAXR>
__device__ __forceinline__ bool vp_update(const float (&rx)[MAXR],
                                          const float (&ry)[MAXR], int R,
                                          long long t, long long alias,
                                          const LkVpScanArgs& a, float& vx,
                                          float& vy) {
  // valid slots: appends k < min(t, R); the aliased slot reads as the VP
  const int nv = t <= 0 ? 0 : (t < R ? (int)t : R);
  const int ka = (alias >= 0 && alias <= t - 1 && alias >= t - R)
                     ? (int)(alias % R) : -1;
  float dx[MAXR], dy[MAXR];
  Sum4 sx, sy;
#pragma unroll
  for (int k = 0; k < MAXR; ++k) {
    if (k < R) {
      dx[k] = (k == ka ? vx : rx[k]) - vx;
      dy[k] = (k == ka ? vy : ry[k]) - vy;
      const float w = k < nv ? 1.f : 0.f;
      sx.add(k, dx[k] * w);
      sy.add(k, dy[k] * w);
    }
  }
  const float m = (float)(nv > 1 ? nv : 1);
  const float mx = sx.total() / m, my = sy.total() / m;
  Sum4 qx, qy;
#pragma unroll
  for (int k = 0; k < MAXR; ++k) {
    if (k < R) {
      const float w = k < nv ? 1.f : 0.f;
      const float ex = dx[k] - mx, ey = dy[k] - my;
      qx.add(k, (ex * ex) * w);
      qy.add(k, (ey * ey) * w);
    }
  }
  const float sdx = sqrtf(qx.total() / m), sdy = sqrtf(qy.total() / m);
  const float hx = mx + sdx * a.clip, lx = mx - sdx * a.clip;
  const float hy = my + sdy * a.clip, ly = my - sdy * a.clip;
  int c = 0;
  Sum4 kx, ky;
#pragma unroll
  for (int k = 0; k < MAXR; ++k) {
    if (k < R) {
      const bool keep = k < nv && dx[k] <= hx && dy[k] <= hy &&
                        dx[k] >= lx && dy[k] >= ly;
      c += keep;
      const float w = keep ? 1.f : 0.f;
      kx.add(k, dx[k] * w);
      ky.add(k, dy[k] * w);
    }
  }
  if (c == 0) return false;
  const float cf = (float)c;
  const float movex = kx.total() / cf, movey = ky.total() / cf;
  vx = vx + movex * a.rate;
  vy = vy + movey * a.rate;
  return true;
}

template <int MAXR>
__global__ void __launch_bounds__(32) vp_scan_kernel(const LkVpScanArgs a) {
  extern __shared__ float smem[];
  const int P = a.P, R = a.R, H = a.H;
  float* s_cx = smem;
  float* s_cy = smem + P;
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(smem + 2 * P);
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t bp = (size_t)b * P;
  float* rows = a.update_rows + 2 * bp;
  float* cp_out = a.cp_xy + 2 * bp;
  uint8_t* row_mask = a.update_mask + bp;
  uint8_t* cp_mask = a.cp_mask + bp;
  float* hist = a.o_hist_xy + (size_t)b * H * 2;

  // the new history ring starts as the old one (lane 0 writes the slots
  // the scan updates, after the warp's barrier)
  const float* hist_in = a.hist_xy + (size_t)b * H * 2;
  for (int j = lane; j < 2 * H; j += 32) hist[j] = hist_in[j];
  // stage the stream's candidates; zero the output slots no step writes
  int last = -1;
  for (int i = lane; i < P; i += 32) {
    const bool ok = a.cand[bp + i] != 0;
    s_ok[i] = ok;
    if (ok) {
      s_cx[i] = a.cps[2 * (bp + i)];
      s_cy[i] = a.cps[2 * (bp + i) + 1];
      last = i;
    } else {
      rows[2 * i] = 0.f;
      rows[2 * i + 1] = 0.f;
      cp_out[2 * i] = 0.f;
      cp_out[2 * i + 1] = 0.f;
      row_mask[i] = 0;
      cp_mask[i] = 0;
    }
  }
  last = __reduce_max_sync(FULL, last);
  __syncwarp();
  if (lane != 0) return;

  float vx = a.vp_xy[2 * b], vy = a.vp_xy[2 * b + 1];
  bool init = a.vp_init[b] != 0, moved = a.vp_moved[b] != 0;
  long long t = a.ring_total[b], alias = a.alias_pos[b];
  long long ult = a.vp_ult[b], ht = a.hist_total[b];
  const float* ring_in = a.ring_xy + (size_t)b * R * 2;
  float rx[MAXR], ry[MAXR];
#pragma unroll
  for (int k = 0; k < MAXR; ++k) {
    rx[k] = k < R ? ring_in[2 * k] : 0.f;
    ry[k] = k < R ? ring_in[2 * k + 1] : 0.f;
  }
  int slot = pymod(t, R), hslot = pymod(ht, H);

  for (int i = 0; i <= last; ++i) {
    if (!s_ok[i]) continue;              // a step past no candidate: no-op
    const float cx = s_cx[i], cy = s_cy[i];
    const bool close =
        fabsf(vx - cx) < a.bound_x && fabsf(vy - cy) < a.bound_y;
    const bool accept = !init || close;
    bool upd = false;
    if (accept) {
#pragma unroll
      for (int k = 0; k < MAXR; ++k) {
        if (k == slot) {
          rx[k] = cx;
          ry[k] = cy;
        }
      }
      slot = slot + 1 == R ? 0 : slot + 1;
      ++t;
      if (init) {
        upd = vp_update<MAXR>(rx, ry, R, t, alias, a, vx, vy);
      } else if (t >= R) {               // the init branch
        Sum4 sx, sy;
#pragma unroll
        for (int k = 0; k < MAXR; ++k) {
          if (k < R) {
            sx.add(k, rx[k]);
            sy.add(k, ry[k]);
          }
        }
        vx = sx.total() / a.r_cap;
        vy = sy.total() / a.r_cap;
        init = true;
        alias = a.aliasing ? t - 1 : -1;
        ult = 0;
      }
      if (upd) {
        moved = true;
        ult = 0;
        hist[2 * hslot] = vx;
        hist[2 * hslot + 1] = vy;
        hslot = hslot + 1 == H ? 0 : hslot + 1;
        ++ht;
      }
    }
    rows[2 * i] = vx;
    rows[2 * i + 1] = vy;
    row_mask[i] = upd;
    cp_out[2 * i] = cx;
    cp_out[2 * i + 1] = cy;
    cp_mask[i] = accept;
  }

  a.o_vp_xy[2 * b] = vx;
  a.o_vp_xy[2 * b + 1] = vy;
  a.o_vp_init[b] = init;
  a.o_vp_moved[b] = moved;
  float* ring = a.o_ring_xy + (size_t)b * R * 2;
#pragma unroll
  for (int k = 0; k < MAXR; ++k) {
    if (k < R) {
      ring[2 * k] = rx[k];
      ring[2 * k + 1] = ry[k];
    }
  }
  a.o_ring_total[b] = t;
  a.o_alias_pos[b] = alias;
  a.o_vp_ult[b] = ult;
  a.o_hist_total[b] = ht;
  a.show_row[2 * b] = 0.f;
  a.show_row[2 * b + 1] = 0.f;
  a.show_mask[b] = 0;
  a.vp_hidden[b] = 0;
}

}  // namespace

extern "C" {

// Launches one scan of B streams on `stream`; returns a CUDA error code
// (0 = ok).  R (ring slots) up to 64; P up to what a block's shared memory
// stages (9 bytes a pair).
int lk_vp_scan_launch(const LkVpScanArgs* a, void* stream) {
  if (a->B < 0 || a->P < 0 || a->R < 1 || a->R > 64 || a->H < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a->P * (2 * sizeof(float) + 1);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (a->B == 0) return 0;
  void (*kernel)(const LkVpScanArgs) =
      a->R <= 16 ? vp_scan_kernel<16> : vp_scan_kernel<64>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<a->B, 32, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
