"""Flow lines, cross points, the VP state machine, motion classes and
Hough road-line voting (PyTorch): counterpart of ``lk_tpu.geometry``, with
its exports."""

from lk_tpu_torch.geometry.flowlines import (  # noqa: F401
    flow_line_filter,
    flow_line_stats,
)
from lk_tpu_torch.geometry.crosspoints import (  # noqa: F401
    PAIR_INDICES,
    cross_point_pairs,
)
from lk_tpu_torch.geometry.vanishing import (  # noqa: F401
    VPState,
    init_vp_state,
    process_frame_pairs,
    vanishing_lines,
    vp_show_step,
)
from lk_tpu_torch.geometry.hough import (  # noqa: F401
    HoughResult,
    hough_peaks,
    hough_road_lines,
    hough_vote,
    segment_line_params,
)
