"""Configuration dataclasses of the port: a copy of ``lk_tpu/config.py``.

The port keeps its own copy so that it imports nothing of ``lk_tpu``; the
five classes have the same field names, defaults and methods as there
(tests/test_torch_package.py holds the two copies field for field).  The
comments below are ``lk_tpu``'s: they describe TPU measurements of the JAX
package, not of this port.  Flags that select a TPU kernel or a TPU
precision trade (``LKConfig.pallas_windows``, ``LKConfig.fast_pyramid``,
``PipelineConfig.pallas_finish``, ``DenseLKConfig.fast_pyramid``,
``scharr_mxu``) are accepted for parity and ignored by the port: a CUDA
tensor always takes the port's kernels, a CPU tensor their plain versions,
and every pyramid is the exact f32 form.

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
    # Fetch per-point windows in track_points_batched with the Pallas gather
    # kernel (pipelined DMAs) instead of vmapped dynamic_slice (which lowers
    # to ~2-3.5 us serialized fetches and dominated the batched tracker —
    # measured 8.8 ms fixed cost at B=32xN=20).  Identical math; requires a
    # TPU backend (the serving apps enable it there).
    pallas_windows: bool = False
    # Build the batched tracker's coarse pyramid levels with the fast
    # banded-MXU pyr_down (DEFAULT matmul precision, bf16 data rounding
    # <= 0.5 intensity on 0..255 frames) instead of the bit-exact
    # cv.pyrDown path.  Level 0 — where the final refinement happens — is
    # the raw frame either way; parity vs OpenCV stays < 0.1 px (tested).
    # Only affects fold_tracking_levels / track_points_batched; the
    # single-pair oracle path (track_points) stays exact.
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
    (the last entry extends to deeper levels).  The top level does the real
    search; the well-initialized fine levels only polish.  Swept on v5e
    (scripts/sweep_dense.py, see BENCH_NOTES.md): (1, 1, 6) matches
    (2, 3, 6) and (1, 2, 6) EPE on translation/rotation/zoom scenes
    (0.008/0.036/0.019 px) AND on the hard 12 px-displacement case
    (7.78 vs 7.52 px where OpenCV itself scores 7.9 vs ground truth),
    at 15-60% higher 1080p throughput; cutting top-level iterations
    ((1, 1, 4)) degrades the large-displacement search and is not worth it.
    max_disp: level-0 integer displacement bound for the gather-free warp
    (ops/warp.py shift_select_warp); level L uses max(4, max_disp >> L).
    Total trackable |flow| is bounded by max_disp.
    """

    outer_iters: int = 6
    iter_schedule: Tuple[int, ...] = (1, 1, 1, 6)
    max_disp: int = 32
    # Dense pyramid depth override: the dense paths run this many levels
    # regardless of LKConfig.max_level (0 = follow max_level).  The sparse
    # tracker keeps the reference's maxLevel=2 exactly (LK_Final.py:81-86);
    # the dense flagship is OUR design and a 4th level is strictly better
    # on v5e (r4 A/B, same process): 1850 -> 2256 fps @1080p (the 6
    # resident top iterations run at 136x256 instead of 272x512) AND far
    # more accurate on hard motion (EPE vs GT: 20 px shift 17.3 -> 0.16,
    # 3% zoom 4.55 -> 1.64, 1.5 deg rot 3.07 -> 1.44 px — the deeper
    # coarse search covers displacement the 3-level top clamps) at ~0.001
    # px cost on mild scenes (gate 0.0070 -> 0.0083, natural unchanged).
    pyramid_levels: int = 4
    # Use the Pallas locality-exploiting warp kernel (flow/pallas_kernels.py)
    # instead of the XLA shift-select warp.  Requires TPU (Mosaic); the XLA
    # path remains the portable fallback and the accuracy reference.
    use_pallas_warp: bool = False
    # Fuse whole IC iterations (warp + residual + box sums + solve) into
    # one Pallas kernel per level.  Implies the pallas tiling constraints;
    # drops the per-pixel eps early-stop (converged pixels take |delta|~0
    # steps).
    use_pallas_fused: bool = False
    # With use_pallas_warp, levels running at least this many iterations
    # switch to the fused level kernel automatically: the fused setup
    # (static window stacking) costs ~0.4 ms at 1080p and only amortizes
    # over several iterations (measured: fused wins at x6, loses at x1-x2).
    fused_from_iters: int = 4
    # Compute Scharr gradients + the structure tensor inside the fused level
    # kernel (pallas_kernels.make_fused_lk_level_grads), with the five box
    # sums as banded MXU matmuls: the XLA prologue shrinks from scharr +
    # 3 full-frame box sums + det/eig elementwise to just padding, so the
    # fused kernel pays off from ONE iteration (swept on v5e: 0.68 vs 0.73 ms
    # at 1080p x1, 0.20 vs 0.27 at 540p x1, 0.18 vs 0.29 at 270p x6).  The
    # MXU box sums round data to bf16 (EPE 0.0089 vs 0.0079 px at the 1080p
    # gate).  Off = warp-only XLA glue + the precomputed-A fused kernel at
    # >= fused_from_iters.
    fused_grads_in_kernel: bool = True
    # Hand flow between grads-fused pyramid levels as HALF-res planes
    # upsampled inside the consumer kernel (banded MXU matmuls) instead of
    # the XLA upsample + plane split/join + full-res flow pad between level
    # calls (~0.25 ms/frame of glue at 1080p, measured).  Only activates at
    # single-iteration pad-free levels with aligned tiles; off = the
    # per-level XLA upsample path everywhere (A/B and debugging).
    fused_coarse_chain: bool = True
    # Video-mode temporal warm start (OPT-IN): seed each step's TOP pyramid
    # level with the previous step's converged top-level flow (the prior
    # OpenCV exposes as OPTFLOW_USE_INITIAL_FLOW) and run warm_top_iters
    # there instead of the cold schedule's top count; the first pair runs
    # the full cold schedule.  Measured on v5e @1080p: EPE identical to
    # cold on smooth accelerating motion even at warm_top_iters=1 (+7% fps)
    # — but a hard motion discontinuity (±10 px/frame direction flip)
    # PERMANENTLY corrupts the track (EPE locks at ~22 px: the stale seed
    # centers the warp's residual clamp range, and the bad output re-seeds
    # every following step).  Default off; enable only for streams with
    # guaranteed-smooth motion.  Only affects dense_pyramidal_lk_video.
    video_warm_start: bool = False
    warm_top_iters: int = 2
    # bf16 data for the bandwidth-bound stages of the XLA level path: the
    # five 15x15 box sums (structure tensor + right-hand side) and the warp
    # window DMA.  Accumulation error ~1e-2 relative; gate with bench's EPE.
    bf16_box_sums: bool = False
    bf16_warp_window: bool = False
    # In-kernel Scharr with the column passes as blocked banded bf16 MXU
    # matmuls (pallas_kernels._scharr_mxu_cols): the direct form's column
    # taps are lane-misaligned vector relayouts — measured 19.8 -> 16.6
    # us/tile on the L0 grads kernel (r4 ablation).  Gradient data rounds
    # to bf16 (~0.25 absolute on pixel-scale smoothed rows before the
    # derivative cancellation); end-to-end EPE gated by bench.py.  Only
    # affects the grads-in-kernel fused kernels; geometry-gated per tile.
    scharr_mxu: bool = True
    # Static residual select range (±local px around the tile-reference
    # displacement) for the Pallas warp/fused kernels; each unit costs
    # ~2 select taps per axis per pixel.  Swept on v5e (6/5/4 at th=136):
    # 5 is 7% faster than 6 at 1080p with EPE equal-or-better on mild
    # scenes (gate 0.0076 vs 0.0089, rot 0.049 vs 0.056, zoom 0.026 vs
    # 0.030) and <= 0.03 px worse in the failure-regime strong-zoom scenes
    # where OpenCV itself scores 2-4 px; 4 gives up ~0.08 px there.
    warp_local: int = 5
    # Per-level override of warp_local, indexed like iter_schedule (empty =
    # warp_local everywhere).  Fine levels start from upsampled coarse flow,
    # so their residual-vs-tile-reference range is small: fewer select taps
    # AND a tighter regularizing clamp.  Swept on v5e, same process:
    # (3,4,5) beats (5,5,5) on EVERY scene (gate 0.0069 vs 0.0092 px, rot
    # 0.035 vs 0.049, strong-zoom 3.81 vs 4.09 in the failure regime) at
    # +10% 1080p fps; (2,3,5) is 4% faster still but gives back 0.2 px on
    # strong zoom.
    warp_local_schedule: Tuple[int, ...] = (3, 4, 5, 5)
    # Single-tile levels (the 270p pyramid top) run the VMEM-resident fused
    # kernel: gradients/A/flow persist in scratch across iterations and only
    # the warp window DMA touches HBM per iteration.  0 disables.
    fused_resident_max_h: int = 272
    # Tile-geometry override for the grads-in-kernel fused level (0 = auto:
    # <=136-row bands + pick_tile_w).  Each grid step carries a fixed
    # ~16 us cost dominated by DMA issue/wait overhead (measured round 2),
    # so bigger tiles cut step count — at the price of residual-clamp
    # margin (within-tile flow variation vs warp_local) and VMEM.
    fused_tile_h: int = 0
    fused_tile_w: int = 0
    # Build the coarse-search pyramid with ops.blur.pyr_down(fast=True):
    # both filter+decimate passes as DEFAULT-precision banded MXU matmuls
    # (bf16 data rounding <= 0.5 intensity; the level-0 solve still sees
    # the exact f32 frames).  The exact path stays for cv.pyrDown parity.
    fast_pyramid: bool = True
    # Frame-batched video chunks: dense_pyramidal_lk_video scans CHUNKS of
    # this many pairs, each chunk one launch per pyramid level with the
    # frame index as a grid dimension (pallas_kernels.*_batched) — cold
    # pairs are independent, so K pairs share each kernel's DMA pipeline
    # and the per-frame XLA dispatch glue of the scan amortizes.  Per-pair
    # numerics are bit-identical to the per-frame chain (tests pin it).
    # Requires the prepadded video plan (falls back per-frame otherwise);
    # 0 disables.  Leftover pairs ((T-1) % chunk) run the per-frame chain.
    # Default 4: same-process A/B @1080p r4 measured 1695/1708 -> 1856/1794
    # fps (chunk=6 noisier, no better), bit-identical numerics.
    video_chunk: int = 4
    # MEASURED DEAD END (r5, kept as a tested option): prepadded-chain
    # build without intermediate materializations — ONE combined edge pad
    # and each coarser level decimated STRAIGHT into its unified-padded
    # layout by offset band matmuls (ops/blur.pyr_down_padded), skipping
    # the unpadded level intermediates and per-level jnp.pads.  The HBM
    # bandwidth saved is real, but the decimation matmuls then contract
    # over the PADDED axes on both sides (~49% more MACs at the 1080p L0
    # (56,75,128,555) pads) and the A/B measured 7% SLOWER end-to-end
    # (scripts/exp_padded_build.py: median 1674 vs 1827 fps, EPE terms
    # identical to 4 decimals).  Values match the two-step build to f32
    # accumulation-split rounding (~3e-5 intensity; NOT bit-equal).
    padded_build: bool = False
    # Build the pyramid with the dual-plane Pallas kernel (pallas_kernels.
    # pallas_pyr_down_pair): both frames of a level decimated by ONE kernel
    # that reads the raw frames as fused row-pair views and does all
    # REFLECT_101 border handling in-kernel — no XLA pad/reshape prologue.
    # Measured v5e @1088x1920: 53.7 us/pair vs 66.1 us for fast_pyramid.
    # Requires TPU (Mosaic) and pads the pyramid base to h % 16 == 0 rows
    # (edge mode, the same pad the level kernels apply); levels whose
    # geometry pyr_pair_supported rejects fall back to fast_pyramid.
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
    # Per-frame AVERAGE budget for chunk-compacted output transport (rows
    # per frame; a chunk of T frames shares a T*out_cap buffer).  The
    # update-row / cross-point outputs reserve P = C(tp_num, 2) = 190 slots
    # per frame while real frames emit ~14 (p99 ~100, measured on synthetic
    # road scenes) — compacting on device cuts the host readback ~3x, which
    # dominated multi-stream serving wall time.  0 = off: full fixed-capacity
    # FrameOutputs transport, bit-identical to the reference emission.
    # Compaction is exact unless a chunk's total exceeds the budget, which
    # the host detects from the transported counts and raises on.
    out_cap: int = 0

    # Crop the batched tracker's pyramid levels to the ROI's row band
    # (+ margins): valid tracking points only ever live inside the ROI
    # trapezoid (check_inside culls escapees every frame, reference
    # LK_Final.py:537-541), and the tracker's frame-band window gather is
    # HBM-bound on band height — the ROI covers ~15% of a dashcam frame.
    # Exact for in-band points (flow/sparse._level_row_bands margins);
    # disable for point sets that roam the full frame.
    track_row_band: bool = True

    # Run the serving `finish` (u8->f32 [+tone] + 3x3 blur) as ONE fused
    # Pallas pass per frame (ops/pallas_finish.py) instead of the ~4-pass
    # XLA chain.  TPU-only Mosaic kernel — enable where lk.pallas_windows
    # is enabled (apps/serve.py does).  Blur output is bit-equal; the tone
    # path fuses to an FMA (<= 1 ulp at image scale).
    pallas_finish: bool = False

    def derived_height(self, src_h: int, src_w: int) -> int:
        """Frame height after aspect-preserving resize (LK_Final.py:426-428)."""
        return int(self.width * (src_h / src_w))
