"""Dispatcher: python -m lk_tpu_torch.apps <app> [args...]"""

import importlib
import sys

APPS = ("final", "vp_detect", "classify", "masking", "roadlines", "serve")


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in APPS:
        print(f"usage: python -m lk_tpu_torch.apps <{'|'.join(APPS)}> "
              f"[args...]")
        raise SystemExit(2)
    module = importlib.import_module(f"lk_tpu_torch.apps.{sys.argv[1]}")
    module.main(sys.argv[2:])


if __name__ == "__main__":
    main()
