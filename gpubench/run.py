#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  The cells,
their configurations, traffic mixes and metrics are in BENCHMARK.json;
see gpubench/README.md.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout root in place of this folder: the harness imports as
# the package ``gpubench`` and the program as ``lk_tpu_torch``
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from gpubench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
