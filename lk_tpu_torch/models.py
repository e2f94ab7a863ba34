"""The five reference pipelines as configuration presets: a copy of
``lk_tpu/models/__init__.py`` (SURVEY.md §2.4).

* ``final``     — LK_Final.py:22-54 (2 groups, REP, aliasing quirk, CSV rows
                  on update + show)
* ``vp_detect`` — VP_detection_using_optical_flow.py:22-57 (VP_REF_NUM=10,
                  MIN_FL_LEN=1.0, 5%-width CP start-separation gate, avg_len
                  reset on hide)
* ``classify``  — LK3_classification.py:20-33 (single point pool, EXT
                  replenishment, contrast enhancement, slower update rates,
                  no aliasing, CSV row only per shown frame)
* ``masking``   — LK1_masking.py:12-17 (donut-ROI tracker demo, 100 points)
* ``roadlines`` — LK2_road_line_detection.py:17-22 (trapezoid ROI, 30 points,
                  post-run length analytics)
"""

from __future__ import annotations

import dataclasses

from lk_tpu_torch.config import FeatureConfig, LKConfig, PipelineConfig

FINAL = PipelineConfig()  # defaults mirror LK_Final

VP_DETECT = dataclasses.replace(
    FINAL,
    vp_ref_num=10,
    min_fl_len=1.0,
    cp_min_start_sep_frac=0.05,
    reset_avg_len_on_hide=True,
)

CLASSIFY = dataclasses.replace(
    FINAL,
    num_groups=1,
    vp_update_rate=0.3,
    fl_update_rate=0.01,
    min_fl_len=2.0,
    fl_upd_meth="EXT",
    vp_init_aliasing=False,
    avg_len_update_before_test=False,
    csv_rows_on_update=False,
    contrast_enhance=True,
)

# LK1/LK2 are simpler trackers, not VP pipelines; their knobs live here for
# the corresponding apps.
MASKING = dict(
    width=960,
    n_points=100,
    lk=LKConfig(),
    features=FeatureConfig(max_corners=100),
    # donut ROI fractions (LK1_masking.py:45-54)
    outer=(0.1, 0.1, 0.9, 0.9),
    inner=(0.4, 0.4, 0.6, 0.6),
    replenish_below=25,  # NumOfDot/4 (LK1_masking.py:152-153)
)

ROADLINES = dict(
    width=960,
    n_points=30,
    lk=LKConfig(),
    features=FeatureConfig(max_corners=30),
    # trapezoid ROI fractions (LK2_road_line_detection.py:109-118)
    trapezoid=((0.1, 0.75), (0.4, 0.58), (0.6, 0.58), (0.9, 0.75)),
    replenish_below_frac=1 / 3,  # NumOfDot/3 append policy (LK2:245-260)
)

PRESETS = dict(
    final=FINAL,
    vp_detect=VP_DETECT,
    classify=CLASSIFY,
)
