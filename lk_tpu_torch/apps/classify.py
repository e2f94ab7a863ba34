"""lk.classify — the single-pool variant with contrast enhancement (mirrors
reference LK3_classification.py: one point pool over all 4 sub-masks, EXT
replenishment, tone curve in preprocess, CSV row once per shown frame).

Usage: python -m lk_tpu_torch.apps.classify <video>  (or --synthetic)
"""

import csv

from lk_tpu_torch.apps._common import build_parser, run_vp_app
from lk_tpu_torch.models import CLASSIFY


def main(argv=None, device="cuda"):
    parser = build_parser(__doc__)
    parser.add_argument(
        "--motion-csv", default=None,
        help="write per-frame motion-class fractions "
             "(static,away,toward,lateral) to this CSV",
    )
    args = parser.parse_args(argv)
    pipe = run_vp_app(CLASSIFY, args, device=device)
    if args.motion_csv:
        with open(args.motion_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["static", "away", "toward", "lateral"])
            w.writerows(pipe.motion_rows)
        if not args.quiet:
            print(f"motion: {args.motion_csv} ({len(pipe.motion_rows)} rows)")
    return pipe


if __name__ == "__main__":
    main()
