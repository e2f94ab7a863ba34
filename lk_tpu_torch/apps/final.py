"""lk.final — the full VP pipeline (mirrors reference LK_Final.py).

Usage: python -m lk_tpu_torch.apps.final <video>  (or --synthetic)
Writes ./vps/vps_<name>.csv like the reference (LK_Final.py:722).
"""

from lk_tpu_torch.apps._common import build_parser, run_vp_app
from lk_tpu_torch.models import FINAL


def main(argv=None, device="cuda"):
    args = build_parser(__doc__).parse_args(argv)
    return run_vp_app(FINAL, args, device=device)


if __name__ == "__main__":
    main()
