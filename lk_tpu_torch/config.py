"""Configuration dataclasses of the port: a copy of ``lk_tpu/config.py``.

The port keeps its own copy so that it imports nothing of ``lk_tpu``; the
five classes have the same field names, defaults and methods as there
(tests/test_torch_package.py holds the two copies field for field).  The
comments below say what each field does in the port.  How the JAX
package's defaults were chosen on its TPU, with its measurements, is
recorded beside the fields in ``lk_tpu/config.py``; none of those numbers
is the port's.

Flags that select a TPU kernel or a TPU precision trade
(``LKConfig.pallas_windows``, ``LKConfig.fast_pyramid``,
``PipelineConfig.pallas_finish``, ``DenseLKConfig.fast_pyramid``,
``scharr_mxu``) are accepted for parity and ignored by the port: a CUDA
tensor always takes the port's kernels, a CPU tensor their plain versions,
and every pyramid is the exact f32 form.  ``bf16_box_sums`` and
``bf16_warp_window`` change the numbers and are applied as in ``lk_tpu``
(``flow/dense.py``).

The configs are frozen and hashable, so the port uses them as cache keys
(masks, plans), and the presets are in :mod:`lk_tpu_torch.models`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """Pyramidal Lucas–Kanade parameters (reference ``LK_Final.py:94-96``)."""

    win_size: Tuple[int, int] = (15, 15)  # (width, height), OpenCV order
    max_level: int = 2                    # pyramid levels = max_level + 1
    max_iters: int = 10                   # TERM_CRITERIA_COUNT
    eps: float = 0.03                     # TERM_CRITERIA_EPS on |delta|
    min_eig_threshold: float = 1e-4       # OpenCV minEigThreshold default
    # lk_tpu: fetch the batched tracker's per-point windows with its Pallas
    # gather kernel.  The port fetches them with its window-gather kernel
    # on card tensors whatever this says (same arithmetic).
    pallas_windows: bool = False
    # lk_tpu: build the batched tracker's coarse levels with the banded
    # bf16 matmul pyrDown.  The port's pyramid is exact f32 either way.
    fast_pyramid: bool = False

    @property
    def half_win(self) -> Tuple[float, float]:
        return ((self.win_size[0] - 1) * 0.5, (self.win_size[1] - 1) * 0.5)


@dataclasses.dataclass(frozen=True)
class DenseLKConfig:
    """Dense-flow-specific knobs on top of LKConfig.

    outer_iters: warp+solve rounds for a single level call.  Each solve is
    exact to first order (flow/dense.py).
    iter_schedule: per-level rounds for the pyramid driver, indexed by level
    (the last entry extends to deeper levels).  The top level does the
    search from zero flow; the finer levels start from the upsampled
    coarser flow and only polish it.
    max_disp: level-0 integer displacement bound of the warps; level L
    uses max(4, max_disp >> L).  Total trackable |flow| is bounded by
    max_disp.
    """

    outer_iters: int = 6
    iter_schedule: Tuple[int, ...] = (1, 1, 1, 6)
    max_disp: int = 32
    # Dense pyramid depth: the dense paths run this many levels regardless
    # of LKConfig.max_level (0 = follow max_level), clamped so that the top
    # level stays at least the window size.  The sparse tracker keeps the
    # reference's maxLevel=2 (LK_Final.py:81-86).
    pyramid_levels: int = 4
    # Warp-only levels: the tile-reference local warp (csrc/local_warp.cu
    # on the card) instead of the plain shift-select warp, each level
    # padded to its tile geometry.
    use_pallas_warp: bool = False
    # Fuse whole IC iterations (warp + residual + box sums + solve) into
    # one kernel per level (csrc/fused_lk_level.cu or fused_level_pre.cu);
    # drops the per-pixel eps early stop (converged pixels take |delta|~0
    # steps).
    use_pallas_fused: bool = False
    # With use_pallas_warp, levels running at least this many iterations
    # switch to the fused level kernel.
    fused_from_iters: int = 4
    # Compute the Scharr gradients and the structure tensor inside the
    # fused level kernel (the grads-fused level), so the level runs no
    # prologue.  Off: the plain prologue (Scharr, the three A box sums, the
    # gate) and then the warp-only iterations, or the precomputed-A fused
    # level at >= fused_from_iters.
    fused_grads_in_kernel: bool = True
    # Hand flow between grads-fused levels as half-resolution planes,
    # upsampled inside the consumer kernel, instead of an upsample, a plane
    # split and a pad between level calls.  Only at single-iteration
    # pad-free levels with aligned tiles.
    fused_coarse_chain: bool = True
    # Video mode, opt-in: seed each pair's top level with the previous
    # pair's converged top flow (OpenCV's OPTFLOW_USE_INITIAL_FLOW prior)
    # and run warm_top_iters there instead of the cold schedule's top
    # count; the first pair runs the cold schedule.  A motion
    # discontinuity can lock the track onto a stale seed: enable only for
    # streams with smooth motion.  Only affects dense_pyramidal_lk_video.
    video_warm_start: bool = False
    warm_top_iters: int = 2
    # bf16 data for two stages of the prologue / warp-only level:
    # bf16_box_sums takes the three A box sums and the per-iteration b box
    # sums in bf16 (every add rounded to bf16); and
    # bf16_warp_window reads the local warp's next plane as bf16 (the
    # intensities rounded once, the arithmetic f32).  The grads-fused level
    # ignores both.
    bf16_box_sums: bool = False
    bf16_warp_window: bool = False
    # lk_tpu: the fused kernel's Scharr column passes as bf16 matmuls.  The
    # port's fused level computes the exact f32 Scharr either way.
    scharr_mxu: bool = True
    # Residual range (+-local px around the tile-reference displacement) of
    # the local warp and the fused levels: a pixel's residual beyond it
    # clamps.
    warp_local: int = 5
    # Per-level override of warp_local, indexed like iter_schedule (empty =
    # warp_local everywhere).  Fine levels start from upsampled coarse flow,
    # so their residual against the tile reference is small.
    warp_local_schedule: Tuple[int, ...] = (3, 4, 5, 5)
    # A level whose tile-padded height is at most this many rows (and at
    # most 512 columns wide) runs the grads-fused level as one resident
    # tile.  0 disables.
    fused_resident_max_h: int = 272
    # Tile-geometry override for the grads-fused level (0 = auto: <= 272-row
    # bands and pick_tile_w).  Bigger tiles mean fewer reference
    # displacements, so more of a tile's flow variation falls outside
    # +-warp_local.
    fused_tile_h: int = 0
    fused_tile_w: int = 0
    # lk_tpu: the coarse-search pyramid as bf16 banded matmuls.  The port's
    # pyramid is exact f32 either way.  padded_build requires it, as in
    # lk_tpu.
    fast_pyramid: bool = True
    # Video chunks: dense_pyramidal_lk_video runs chunks of this many cold
    # pairs, each level one kernel launch for all of the chunk's pairs;
    # per pair the numbers equal the per-frame chain's bit for bit.  Needs
    # the video plan (the per-frame chain runs otherwise); leftover pairs
    # ((T-1) % chunk) run the per-frame chain.  0 disables.
    video_chunk: int = 4
    # Build the video's pyramid with no intermediate level copies.  The
    # port's one-launch build (the base pad folded into the first level's
    # addresses) already works that way, so this changes nothing in the
    # port's numbers; on the video plan it needs fast_pyramid, as in
    # lk_tpu, whose padded build differs from its two-step build in f32
    # rounding.
    padded_build: bool = False
    # Pad the pyramid base to a multiple of 16 rows (edge mode) for the
    # pyrDown pair kernel and decimate both frames of a pair in one launch.
    # The port builds every pyramid in one launch of csrc/pyr_down.cu; the
    # flag keeps lk_tpu's base geometry (dense.pyramid_base_geometry).
    pallas_pyramid: bool = False

    def level_disp(self, level: int) -> int:
        return max(4, self.max_disp >> level)

    def level_iters(self, level: int) -> int:
        s = self.iter_schedule
        return s[min(level, len(s) - 1)] if s else self.outer_iters

    def level_local(self, level: int) -> int:
        s = self.warp_local_schedule
        return s[min(level, len(s) - 1)] if s else self.warp_local


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Shi–Tomasi / goodFeaturesToTrack parameters (reference ``LK_Final.py:88-91``)."""

    max_corners: int = 5          # int(TP_NUM/4) in the VP pipelines
    quality_level: float = 0.3    # relative to max response
    min_distance: float = 7.0     # greedy NMS radius
    block_size: int = 7           # structure-tensor window


@dataclasses.dataclass(frozen=True)
class ROIConfig:
    """Road-trapezoid ROI fractions (reference ``LK_Final.py:437-446``)."""

    outer_l: float = 0.2
    outer_u: float = 0.65
    outer_r: float = 0.8
    outer_d: float = 0.8
    inner_l: float = 0.47
    inner_u: float = 0.65
    inner_r: float = 0.52
    inner_d: float = 0.65


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full VP-pipeline configuration (SURVEY.md §2.4 hyper-parameter matrix).

    Defaults reproduce the reference ``LK_Final.py`` constants
    (``LK_Final.py:22-54``).  The compat flags at the bottom reproduce
    behavioral quirks of specific reference scripts so trajectories can be
    matched bit-for-bit where wanted (SURVEY.md §7 "faithful quirk set").
    """

    width: int = 860                  # WID: resize target width
    tp_num: int = 20                  # max simultaneous tracking points
    vp_ref_num: int = 15              # recent CPs per VP update
    vp_update_rate: float = 0.5
    fl_update_rate: float = 0.05      # EMA rate for average flow length
    tp_update_rate: float = 0.3       # replenish when live < tp_num * this
    tp_update_time: int = 10          # forced replenish period (frames)
    min_ang_dif: float = 25.0         # degrees
    max_cp_std: float = 1.0
    min_fl_len: float = 1.5
    cp_thold: float = 1.0 / 15.0
    hide_vp_thold: int = 50
    fl_upd_meth: str = "REP"          # "REP" | "EXT"
    vp_ref: int = 300                 # VP-history window for VL regression

    lk: LKConfig = LKConfig()
    features: FeatureConfig = FeatureConfig()
    roi: ROIConfig = ROIConfig()

    # --- structural variants -------------------------------------------------
    # Number of independent point groups: 2 in LK_Final/VP_det
    # (reference LK_Final.py:481-492), 1 in LK3 (LK3_classification.py:342-347).
    num_groups: int = 2

    # --- compat quirks (SURVEY.md §2.3 / §7) ---------------------------------
    # LK_Final.py:617-624 rebinds the loop variable `vp`, aliasing the new VP
    # with the last accepted cross point; diffs against that slot are then 0.
    vp_init_aliasing: bool = True
    # LK_Final updates avg_len BEFORE the accept test (LK_Final.py:557-558);
    # LK3 updates it AFTER (LK3_classification.py:411-417).
    avg_len_update_before_test: bool = True
    # VP_det additionally requires >= 5%*WID horizontal start separation of
    # the two lines forming a CP (VP_detection_using_optical_flow.py:588-589).
    cp_min_start_sep_frac: float = 0.0
    # VP_det resets avg_len on VP hide (VP_det:644-648); LK_Final does not.
    reset_avg_len_on_hide: bool = False
    # LK_Final appends a VP row both on every update and once in the show
    # block (LK_Final.py:612-614,637-638); LK3 appends only in the show block.
    csv_rows_on_update: bool = True
    # LK3 applies the contrast tone curve inside process_img (LK3:274).
    contrast_enhance: bool = False
    # Per-frame average budget for chunk-compacted output transport (rows
    # per frame; a chunk of T frames shares a T*out_cap buffer).  The
    # update-row / cross-point outputs reserve P = C(tp_num, 2) = 190 slots
    # per frame, most of them empty: compacting on the device shrinks what
    # the host reads back.  0 = off: full fixed-capacity FrameOutputs
    # transport, bit-identical to the reference emission.  Compaction is
    # exact unless a chunk's total exceeds the budget, which the host
    # detects from the transported counts and raises on.
    out_cap: int = 0

    # Crop the batched tracker's pyramid levels to the ROI's row band
    # (+ margins): valid tracking points only ever live inside the ROI
    # trapezoid (check_inside culls escapees every frame, reference
    # LK_Final.py:537-541), so the window gather reads only that band.
    # Exact for in-band points (flow/sparse._level_row_bands margins);
    # disable for point sets that roam the full frame.
    track_row_band: bool = True

    # lk_tpu: run the serving finish (u8 -> f32 [+ tone] + 3x3 blur) as its
    # fused Pallas pass.  The port runs its finish kernel (csrc/finish.cu)
    # on card tensors whatever this says; the blur is bit-equal.
    pallas_finish: bool = False

    def derived_height(self, src_h: int, src_w: int) -> int:
        """Frame height after aspect-preserving resize (LK_Final.py:426-428)."""
        return int(self.width * (src_h / src_w))
