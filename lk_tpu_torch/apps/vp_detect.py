"""lk.vp_detect — VP detection with video writeout (mirrors reference
VP_detection_using_optical_flow.py: VP_REF_NUM=10, MIN_FL_LEN=1.0, the
5%-width CP start-separation gate, avg_len reset on hide).

Usage: python -m lk_tpu_torch.apps.vp_detect <video> [--write-video out.avi]
(with a video path and no --write-video, the overlay goes to
./saved_video/<name>.avi, which needs OpenCV)
"""

import os

from lk_tpu_torch.apps._common import build_parser, run_vp_app
from lk_tpu_torch.models import VP_DETECT


def main(argv=None, device="cuda"):
    args = build_parser(__doc__).parse_args(argv)
    if args.write_video is None and args.video:
        name = os.path.basename(args.video).split(".")[0]
        args.write_video = f"./saved_video/{name}.avi"
    return run_vp_app(VP_DETECT, args, device=device)


if __name__ == "__main__":
    main()
